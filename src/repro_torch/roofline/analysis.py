"""Three-term roofline of one rank's traced step on the NVIDIA H100 (the
port's ``repro.roofline.analysis``; its constants are the TPU v5e's).

  compute term    = sum over dtypes of FLOPs_per_device / PEAK[dtype]
  memory term     = HBM_bytes_per_device / HBM_BW
  collective term = wire_bytes_per_device / NET_BW

Hardware constants (one H100 SXM at its 700 W limit, NVIDIA's data sheet,
dense rates): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32
outside them (TF32 stays off, as the port's fp32 parity needs), 34
TFLOP/s float64 outside them; 3.35 TB/s of HBM3.  The collective term
puts every wire byte on the network between hosts at 50 GB/s a card (a
DGX H100 has one 400 Gb/s ConnectX-7 NIC per GPU): the (16, 16) and
(2, 16, 16) meshes span 32 and 64 eight-card hosts.  The NVLink term puts
them on NVLink 4's 450 GB/s each way a card instead (the best case, a
mesh inside one NVLink domain); both are recorded.

MODEL_FLOPS (the "useful compute" yardstick), as the reference's:
  train:   (6*N_active*T + 6*B*S^2*attn_dim*L_attn) / devices
  prefill: (2*N_active*T + 2*B*S^2*attn_dim*L_attn) / devices
  decode:  (2*N_active*B + 4*B*S_ctx*attn_dim*L_attn) / devices   (per step)
(causal attention halves the S^2 terms — included.)  The ratio
MODEL_FLOPS / counted FLOPs exposes remat/dispatch/padding waste.
"""
from __future__ import annotations

import gzip
import json
from typing import Dict

from ..configs.base import ArchConfig, ShapeConfig
from .op_cost import Cost

PEAK_FLOPS = 989e12          # bf16 on the tensor cores, per card
PEAK_FLOPS_BY_DTYPE = {"bfloat16": 989e12, "float16": 989e12,
                       "float32": 67e12, "float64": 34e12}
HBM_BW = 3.35e12             # bytes/s per card
NET_BW = 50e9                # bytes/s per card between hosts
NVLINK_BW = 450e9            # bytes/s per card each way, NVLink 4


def attn_layers(cfg: ArchConfig) -> int:
    return sum(1 for i in range(cfg.n_layers) if cfg.block_is_attention(i))


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Global useful FLOPs for one step of this cell."""
    B, S = shape.global_batch, shape.seq_len
    T = B * S
    N = cfg.n_active_params()
    L = attn_layers(cfg)
    ad = cfg.attn_dim
    if shape.kind == "train":
        return 6.0 * N * T + 6.0 * B * S * S * ad * L / 2.0 * 2.0
    if shape.kind == "prefill":
        return 2.0 * N * T + 2.0 * B * S * S * ad * L
    # decode: one token per sequence against an S-token context
    return 2.0 * N * B + 4.0 * B * S * ad * L


def compute_seconds(cost: Cost) -> float:
    """Each dtype's FLOPs over its own peak (an unlisted dtype at the
    float32 one)."""
    by = dict(cost.flops_by_dtype)
    rest = cost.flops - sum(by.values())
    if rest > 0:
        by["float32"] = by.get("float32", 0.0) + rest
    return sum(f / PEAK_FLOPS_BY_DTYPE.get(k, PEAK_FLOPS_BY_DTYPE["float32"])
               for k, f in by.items())


def analyze_cost(cost: Cost, cfg: ArchConfig, shape: ShapeConfig,
                 devices: int) -> Dict:
    mf = model_flops(cfg, shape) / devices
    compute_s = compute_seconds(cost)
    memory_s = cost.hbm_bytes / HBM_BW
    coll_bytes = cost.total_coll_bytes()
    collective_s = coll_bytes / NET_BW
    collective_s_nvlink = coll_bytes / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    roofline_fraction = (mf / PEAK_FLOPS) / bound if bound > 0 else 0.0
    return {
        "hlo_flops_per_dev": cost.flops,
        "hlo_bytes_per_dev": cost.hbm_bytes,
        "collective_bytes_per_dev": coll_bytes,
        "collective_breakdown": dict(cost.coll_bytes),
        "collective_counts": dict(cost.coll_counts),
        "flops_by_dtype": dict(cost.flops_by_dtype),
        "model_flops_per_dev": mf,
        "model_to_hlo_flops": (mf / cost.flops) if cost.flops else 0.0,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "collective_s_nvlink": collective_s_nvlink,
        "dominant": dominant,
        "step_time_bound_s": bound,
        "roofline_fraction": roofline_fraction,
        "unknown_trip_whiles": cost.unknown_trip_whiles,
    }


def analyze_cell(cost: Cost, cfg: ArchConfig, shape: ShapeConfig,
                 cell_meta: Dict) -> Dict:
    """``analyze_cost`` over the cell's device count (the reference's
    takes the HLO text; the port's trace gives the ``Cost`` itself)."""
    return analyze_cost(cost, cfg, shape, cell_meta.get("devices", 1))


def cost_from_json(d: Dict) -> Cost:
    """A ``Cost`` from a cell JSON's ``cost_analysis``."""
    return Cost(flops=d["flops"], hbm_bytes=d["bytes accessed"],
                coll_bytes=dict(d["collective_bytes"]),
                coll_counts=dict(d["collective_counts"]),
                unknown_trip_whiles=int(d.get("unknown_trip_whiles", 0)),
                flops_by_dtype=dict(d["flops_by_dtype"]))


def analyze_file(json_path: str, cfg: ArchConfig, shape: ShapeConfig,
                 devices: int) -> Dict:
    """The roofline of a written cell (its ``.json``, or its gzipped
    copy), from its ``cost_analysis``."""
    opener = gzip.open if json_path.endswith(".gz") else open
    with opener(json_path, "rt") as f:
        cell = json.load(f)
    return analyze_cost(cost_from_json(cell["cost_analysis"]), cfg, shape,
                        devices)


def suggest(result: Dict) -> str:
    """One sentence on what would move the dominant term down."""
    d = result["dominant"]
    if d == "collective":
        top = max(result["collective_breakdown"],
                  key=result["collective_breakdown"].get)
        return (f"collective-bound ({top}): reshard to keep the reduction "
                f"local (reduce-scatter in place of all-reduce, shrink the "
                f"group, keep it inside one NVLink domain, or overlap it "
                f"with compute)")
    if d == "memory":
        return ("memory-bound: raise arithmetic intensity — fuse the "
                "elementwise chains into the matmuls' epilogues (the port "
                "runs each aten op as its own kernel), shrink remat "
                "recompute, keep activations bf16, tile for shared-memory "
                "reuse")
    return ("compute-bound: good place to be — close the MODEL/counted "
            "flops gap (remat policy, MoE dispatch, padding) and overlap "
            "the remaining collectives")
