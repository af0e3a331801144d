"""The port's dry run (``repro_torch.launch.dryrun``) on reduced cells
against the reference's, and against the same programs run for real.

FLOPs a device: reduced olmo-1b, mamba2-130m, grok-1-314b and jamba at
small train / prefill / decode shapes on a (2, 2) mesh, TP on in both
packages, the port's fake trace against the reference's ``lower_cell`` +
``parse_and_cost`` (run in a subprocess with four forced host devices,
``tests/_torch_dryrun_cases.py``).  The ops that make up the gap:

* the prefill's attention: dense (S, S) score and P.V dots in the
  reference, ``flash_attention`` in the port, whose record counts the
  causal half (S(S+1)/2 pairs a head): added back at 2S/(S+1) - 1 of it;
* the loss's gold logit: a one-hot dot over the vocab in the reference's
  HLO (2 * B * S * V / devices), an elementwise product and sum in the
  port's ``chunked_ce_loss``: added back;
* ``isla_fold``'s record (17 operations a sample of the loss telemetry):
  the reference folds with elementwise ops, no dot: taken out.

With those the dense-attention and MoE cells agree exactly
(``FLOP_TOL``).  Two more the port computes and the reference does not,
left in and held to ``FLOP_TOL_REPLICATED``:

* the Mamba B/C projections (``wB``, ``wC``: no TP rule, whole weights)
  and their gradients, computed whole on each "model" rank where the
  reference's GSPMD splits the tokens: every Mamba cell;
* a decode step's MoE dispatch and combine, whose one routing group (8
  tokens) every "data" rank computes whole (``moe._local_moe`` splits
  groups over the dp axes only where they divide): grok and jamba decode.

Collectives: the fake (2, 2) trace's collectives (count and input bytes
of each op) equal ``chip_smoke.CollectiveCounter``'s on four gloo ranks
running the same reduced programs for real (a ``cpu`` mesh on both
sides, where DTensor takes the same paths)."""
import gzip
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

import _torch_dryrun_cases as DC
import _torch_mesh_lm_cases as M
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOP_TOL = 1e-12            # the same products, counted exactly
FLOP_TOL_REPLICATED = 0.06  # Mamba cells, MoE decode: 3.2-5.5% seen
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]),
        JAX_PLATFORMS="cpu",
        XLA_FLAGS_EXTRA="--xla_force_host_platform_device_count=4")
    subprocess.run([sys.executable, "-c",
                    "import _torch_dryrun_cases as D; "
                    f"D.reference_main({str(out)!r})"],
                   env=env, check=True, cwd=ROOT, timeout=600)
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        DC.patch_port(mp)
        return DC.port_cells(tmp_path_factory.mktemp("port"))
    finally:
        mp.undo()


def _reference_products(cell, cfg) -> float:
    """The port's counted flops of ``cell`` as the reference counts them:
    the flash records at their dense size, the gold logit's dot added,
    the fold's elementwise operations taken out."""
    s, b = cell["seq_len"], cell["global_batch"]
    flops = cell["cost_analysis"]["flops"]
    for k in cell["kernels"]:
        if k["name"] == "flash_attention":
            flops += k["flops"] * (2 * s / (s + 1) - 1)
        else:
            flops -= k["flops"]
    if cell["kind"] == "train":
        flops += 2.0 * b * s * cfg.padded_vocab / cell["devices"]
    return flops


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a in DC.ARCHS
                                  for s in DC.KINDS])
def test_flops_a_device_are_the_references(reference, port, cell):
    got, want = port[cell], reference[cell]
    assert got["status"] == "ok", got.get("traceback")
    arch = cell.split("/")[0]
    names = sorted({k["name"] for k in got["kernels"]})
    has_attn = arch != "mamba2-130m"
    assert names == {"train_4k": ["isla_fold"],
                     "prefill_32k": ["flash_attention"] * has_attn,
                     "decode_32k": []}[cell.split("/")[1]]
    flops = _reference_products(got, get_config(arch, reduced=True))
    replicated = arch in ("mamba2-130m", "jamba-1.5-large-398b") or (
        arch == "grok-1-314b" and got["kind"] == "decode")
    if replicated:
        assert want["flops"] < flops <= want["flops"] * (
            1 + FLOP_TOL_REPLICATED), (flops, want["flops"])
    else:
        assert flops == pytest.approx(want["flops"], rel=FLOP_TOL), (
            flops, want["flops"])


@pytest.mark.parametrize("arch", ["olmo-1b", "grok-1-314b"])
def test_fake_collectives_are_a_gloo_runs(tmp_path, monkeypatch, arch):
    """TP, FSDP and the sequence constraint on (``TP_THRESHOLD`` and the
    FSDP thresholds at 0): each reduced cell's collectives on the fake
    (2, 2) group equal four gloo ranks' on the same program, op by op."""
    from repro_torch.sharding import specs as SP
    M.spawn(DC.gloo_collectives, 4, tmp_path, str(tmp_path), arch)
    with open(tmp_path / f"gloo_{arch}.json") as f:
        gloo = json.load(f)
    DC.patch_port(monkeypatch)
    for name in ("TP_THRESHOLD", "FSDP_THRESHOLD", "FSDP_MIN_ELEMENTS"):
        monkeypatch.setattr(SP, name, 0)
    fake = DC.fake_collectives(arch, tmp_path / "fake")
    assert set(fake) == set(gloo) == set(DC.KINDS)
    for shape in DC.KINDS:
        assert fake[shape] == gloo[shape], shape
    assert sum(v["count"] for v in fake["train_4k"].values()) > 10


def test_cell_json_keys_and_the_long_context_skip(tmp_path, monkeypatch):
    DC.patch_port(monkeypatch)
    r = dryrun.run_cell("olmo-1b", "decode_32k", False, str(tmp_path))
    assert r["status"] == "ok"
    for key in ("arch", "shape", "mesh", "devices", "params",
                "active_params", "seq_len", "global_batch", "kind",
                "status", "t_trace_s", "memory_analysis", "cost_analysis",
                "roofline", "kernels", "ops_path", "trace_device"):
        assert key in r, key
    assert set(r["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
        "alias_size_in_bytes"}
    assert r["memory_analysis"]["alias_size_in_bytes"] > 0
    assert r["memory_analysis"]["temp_size_in_bytes"] > 0
    assert r["devices"] == 4 and r["roofline"]["dominant"] in (
        "compute", "memory", "collective")
    with gzip.open(r["ops_path"], "rt") as f:
        ops = json.load(f)
    assert ops[0]["bytes"] >= ops[-1]["bytes"]
    with open(tmp_path / "olmo-1b__decode_32k__single.json") as f:
        assert json.load(f) == r
    skip = dryrun.run_cell("olmo-1b", "long_500k", True, str(tmp_path))
    assert skip == {"arch": "olmo-1b", "shape": "long_500k",
                    "mesh": "multi", "status": "skip",
                    "reason": "SKIP(full-attention): 512k dense-KV decode "
                              "out of scope"}
    assert not dist.is_initialized()


def test_cli_exits_1_on_a_failing_cell(tmp_path, monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("spoiled cell")
    monkeypatch.setattr(dryrun, "lower_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k",
                     "--mesh", "single", "--out", str(tmp_path)])
    assert e.value.code == 1
    assert "fail  RuntimeError: spoiled cell" in capsys.readouterr().out
    with open(tmp_path / "olmo-1b__train_4k__single.json") as f:
        r = json.load(f)
    assert r["status"] == "fail" and "spoiled cell" in r["traceback"]


def test_cli_traces_olmo_train_at_full_size_without_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch olmo-1b --shape
    train_4k --mesh single`` with ``jax`` and ``repro`` unimportable:
    exit 0, the cell's JSON ``ok`` with per-device counts and the H100
    roofline terms."""
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "sys.argv = ['dryrun', '--arch', 'olmo-1b', '--shape', "
            "'train_4k', '--mesh', 'single']; "
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               DRYRUN_OUT=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    with open(tmp_path / "olmo-1b__train_4k__single.json") as f:
        r = json.load(f)
    assert r["status"] == "ok" and r["devices"] == 256
    rf = r["roofline"]
    assert rf["hlo_flops_per_dev"] > rf["model_flops_per_dev"] > 0
    assert rf["collective_bytes_per_dev"] > 0
    assert rf["compute_s"] > 0 and rf["memory_s"] > 0
    assert [k["name"] for k in r["kernels"]] == ["isla_fold"]
    assert "-> ok" in p.stdout
