"""The port's roofline (``repro_torch.roofline``) against the reference's
``repro.roofline``: the yardstick (``model_flops``, ``attn_layers``) bit
for bit; ``analyze_cost`` key for key with the reference's constants
patched in; each collective kind's wire bytes and each matrix product's
flops against ``hlo_parse`` on a one-op HLO text of the same shapes; and
the counter's two traps (the DTensor-level op at global shapes, the
sharding propagator's shape inference), the kernels' fake branch, and
the fake process group's teardown."""
import pytest
import torch
import torch.distributed as dist

import _torch_dryrun_cases as DC
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import list_archs as ref_archs
from repro.roofline import analysis as RA
from repro.roofline import hlo_parse as RH
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis as TA
from repro_torch.roofline import op_cost as OC


@pytest.fixture
def fake16():
    """A fake 16-rank group (this process rank 0) with a (4, 4) cpu
    mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    with dryrun.fake_world(16):
        yield init_device_mesh("cpu", (4, 4), mesh_dim_names=("a", "b"))
    assert not dist.is_initialized()


def _fake(*shape, dtype=torch.float32):
    from torch._subclasses.fake_tensor import FakeTensorMode
    fm = FakeTensorMode()
    with fm:
        return fm, torch.empty(shape, dtype=dtype)


def test_yardstick_is_the_references_bit_for_bit():
    assert list_archs() == ref_archs()
    for arch in list_archs():
        cfg, rcfg = get_config(arch), ref_config(arch)
        assert TA.attn_layers(cfg) == RA.attn_layers(rcfg), arch
        for name in SHAPES:
            assert TA.model_flops(cfg, SHAPES[name]) == RA.model_flops(
                rcfg, REF_SHAPES[name]), (arch, name)


def test_analyze_cost_is_the_references_with_its_constants(monkeypatch):
    """The reference's v5e constants patched into the port's module (one
    peak for every dtype, the 4-link ICI as the NVLink term): every key of
    the reference's result, ``collective_s_4link`` read as
    ``collective_s_nvlink``, and only ``flops_by_dtype`` beside them."""
    monkeypatch.setattr(TA, "PEAK_FLOPS", RA.PEAK_FLOPS)
    monkeypatch.setattr(TA, "PEAK_FLOPS_BY_DTYPE",
                        {k: RA.PEAK_FLOPS for k in TA.PEAK_FLOPS_BY_DTYPE})
    monkeypatch.setattr(TA, "HBM_BW", RA.HBM_BW)
    monkeypatch.setattr(TA, "NET_BW", RA.ICI_BW_LINK)
    monkeypatch.setattr(TA, "NVLINK_BW", RA.ICI_BW_LINK * RA.ICI_LINKS)
    for flops, hbm, coll in ((3.1e13, 2.2e11, 4.0e9), (1e9, 8e11, 1e6),
                             (5e12, 1e9, 3e11)):
        ref = RH.Cost(flops=flops, hbm_bytes=hbm)
        ref.coll_bytes["all-gather"] = coll
        ref.coll_counts["all-gather"] = 3
        ref.coll_bytes["all-reduce"] = coll / 7
        ref.coll_counts["all-reduce"] = 2
        port = OC.Cost(flops=flops, hbm_bytes=hbm,
                       coll_bytes=dict(ref.coll_bytes),
                       coll_counts=dict(ref.coll_counts),
                       flops_by_dtype={"bfloat16": flops})
        for arch, shape in (("olmo-1b", "train_4k"),
                            ("jamba-1.5-large-398b", "decode_32k")):
            want = RA.analyze_cost(ref, ref_config(arch), REF_SHAPES[shape],
                                   256)
            got = TA.analyze_cost(port, get_config(arch), SHAPES[shape], 256)
            want["collective_s_nvlink"] = want.pop("collective_s_4link")
            assert set(got) - set(want) == {"flops_by_dtype"}
            for k, w in want.items():
                assert got[k] == pytest.approx(w, rel=1e-12), k


def test_h100_constants_and_per_dtype_compute():
    """Each dtype's flops over its own peak (NVIDIA's H100 SXM sheet)."""
    assert TA.PEAK_FLOPS_BY_DTYPE == {"bfloat16": 989e12,
                                      "float16": 989e12, "float32": 67e12,
                                      "float64": 34e12}
    assert (TA.HBM_BW, TA.NET_BW, TA.NVLINK_BW) == (3.35e12, 50e9, 450e9)
    c = OC.Cost(flops=989e12 + 67e12,
                flops_by_dtype={"bfloat16": 989e12, "float32": 67e12})
    assert TA.compute_seconds(c) == pytest.approx(2.0)


_HLO = """HloModule m

%add (x: f32[], y: f32[]) -> f32[] {{
  %x = f32[] parameter(0)
  %y = f32[] parameter(1)
  ROOT %s = f32[] add(%x, %y)
}}

ENTRY %main (p: f32[64,128]) -> {out} {{
  %p = f32[64,128]{{1,0}} parameter(0)
  ROOT %c = {out}{{1,0}} {op}(%p), replica_groups=[4,4]<=[16]{attrs}
}}
"""


@pytest.mark.parametrize("kind", OC.COLLECTIVES)
def test_collective_wire_bytes_are_hlo_parses(fake16, kind):
    """One collective over a group of 4 of a (64, 128) fp32 tensor: the
    port's counted wire bytes (a ``_c10d_functional`` op on fake tensors
    over the (4, 4) mesh's second dim) equal ``parse_and_cost``'s on the
    HLO op of the same shapes and group."""
    import torch.distributed._functional_collectives as funcol
    out = {"all-reduce": "f32[64,128]", "all-gather": "f32[256,128]",
           "reduce-scatter": "f32[16,128]", "all-to-all": "f32[64,128]",
           "collective-permute": "f32[64,128]"}[kind]
    attrs = {"all-reduce": ", to_apply=%add",
             "reduce-scatter": ", dimensions={0}, to_apply=%add",
             "all-gather": ", dimensions={0}",
             "all-to-all": ", dimensions={0}",
             "collective-permute": ""}[kind]
    text = _HLO.format(out=out, op=kind, attrs=attrs)
    want = RH.parse_and_cost(text)
    assert want.coll_counts[kind] == 1
    fm, t = _fake(64, 128)
    group = (fake16, 1)
    if kind == "collective-permute":
        # DTensor issues no permute (funcol's permute_tensor is an
        # all-to-all): the rule alone, on the HLO op's bytes
        got = OC.wire_bytes(kind, 64 * 128 * 4, 64 * 128 * 4, 4)
        assert got == want.coll_bytes[kind]
        return
    with fm, OC.CostCounter() as c:
        if kind == "all-reduce":
            r = funcol.all_reduce(t, "sum", group)
        elif kind == "all-gather":
            r = funcol.all_gather_tensor(t, 0, group)
        elif kind == "reduce-scatter":
            r = funcol.reduce_scatter_tensor(t, "sum", 0, group)
        else:
            r = funcol.all_to_all_single(t, None, None, group)
        r = funcol.wait_tensor(r) if hasattr(r, "wait") else r
    assert c.cost.coll_counts[kind] == 1
    assert sum(c.cost.coll_counts.values()) == 1
    assert c.cost.coll_bytes[kind] == want.coll_bytes[kind]


def _dot_hlo(lhs, rhs, out, lhs_c, rhs_c, batch=None):
    def ty(s):
        return f"f32[{','.join(map(str, s))}]"
    b = (f", lhs_batch_dims={{{batch}}}, rhs_batch_dims={{{batch}}}"
         if batch is not None else "")
    return f"""HloModule m

ENTRY %main (a: {ty(lhs)}, b: {ty(rhs)}) -> {ty(out)} {{
  %a = {ty(lhs)} parameter(0)
  %b = {ty(rhs)} parameter(1)
  ROOT %d = {ty(out)} dot(%a, %b){b}, lhs_contracting_dims={{{lhs_c}}}, rhs_contracting_dims={{{rhs_c}}}
}}
"""


@pytest.mark.parametrize("case", ["mm", "bmm", "einsum"])
def test_product_flops_are_hlo_parses(case):
    """2 * output elements * contracted size: ``torch.mm``, ``torch.bmm``
    and a batched einsum counted by the port equal the reference's
    ``_dot_flops`` on the dot of the same shapes."""
    if case == "mm":
        a, b = torch.randn(24, 40), torch.randn(40, 56)
        text = _dot_hlo((24, 40), (40, 56), (24, 56), 1, 0)
        fn = torch.mm
    elif case == "bmm":
        a, b = torch.randn(3, 24, 40), torch.randn(3, 40, 56)
        text = _dot_hlo((3, 24, 40), (3, 40, 56), (3, 24, 56), 2, 1, 0)
        fn = torch.bmm
    else:
        a, b = torch.randn(5, 24, 40), torch.randn(5, 56, 40)
        text = _dot_hlo((5, 24, 40), (5, 56, 40), (5, 24, 56), 2, 2, 0)

        def fn(x, y):
            return torch.einsum("bij,bkj->bik", x, y)
    with OC.CostCounter() as c:
        fn(a, b)
    assert c.cost.flops == RH.parse_and_cost(text).flops
    assert c.cost.flops_by_dtype == {"float32": c.cost.flops}


def test_sharded_product_counts_the_local_product():
    """(2048, 4096) x (4096, 16384) with x split on rows over one mesh dim
    and w on columns over the other, on a fake (16, 16) mesh: rank 0
    computes one (128, 4096) x (4096, 1024) product, 1.07e9 flops, not
    the global 2.75e11; the propagator's first-call shape inference is not
    counted, so a second identical call counts the same."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dryrun.fake_world(256):
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        fm, xl = _fake(128, 4096, dtype=torch.bfloat16)
        with fm:
            wl = torch.empty(4096, 1024, dtype=torch.bfloat16)
        x = DTensor.from_local(xl, mesh, [Shard(0), Replicate()],
                               run_check=False)
        w = DTensor.from_local(wl, mesh, [Replicate(), Shard(1)],
                               run_check=False)
        counts = []
        for _ in range(2):
            with fm, OC.CostCounter() as c:
                y = x @ w
            counts.append((c.cost.flops, dict(c.ops)))
        assert y.shape == (2048, 16384)
    assert counts[0][0] == 2.0 * 128 * 1024 * 4096
    assert counts[0][0] == pytest.approx(1.07e9, rel=4e-3)
    assert counts[0] == counts[1]
    assert counts[0][1]["aten.mm"]["count"] == 1


def test_tracing_a_cell_twice_counts_the_same(tmp_path, monkeypatch):
    DC.patch_port(monkeypatch)
    rows = []
    for _ in range(2):
        r = dryrun.run_cell("olmo-1b", "train_4k", False, str(tmp_path),
                            force=True)
        assert r["status"] == "ok", r.get("traceback")
        rows.append((r["cost_analysis"], r["kernels"],
                     r["memory_analysis"]))
    assert rows[0] == rows[1]
    assert [k["name"] for k in rows[0][1]] == ["isla_fold"]
    assert not dist.is_initialized()


def test_fake_group_is_destroyed_when_a_cell_fails(tmp_path, monkeypatch):
    def boom(*a, **k):
        assert dist.is_initialized() and dist.get_world_size() == 256
        raise RuntimeError("spoiled")
    monkeypatch.setattr(dryrun, "lower_cell", boom)
    r = dryrun.run_cell("olmo-1b", "train_4k", False, str(tmp_path),
                        force=True)
    assert r["status"] == "fail" and "spoiled" in r["error"]
    assert not dist.is_initialized()


def test_kernels_record_their_cost_and_infer_shapes_on_fakes():
    """Fake inputs: flash_attention and ops.isla_moments return empty
    outputs of the right shape and record one kernel each, with row 8's
    and row 2's bound (operations, bytes); nothing else but the
    allocations and the fold's own small ops runs."""
    fm, q = _fake(8, 64, 32, dtype=torch.bfloat16)
    with fm:
        k = torch.empty(4, 64, 32, dtype=torch.bfloat16)
        vals = torch.empty(3, 1000)
    with fm, OC.CostCounter() as c:
        o = flash_attention(q, k, k, groups=2)
        m = ops.isla_moments(vals, [0.0, 1.0, 2.0, 3.0])
    assert o.shape == q.shape and o.dtype == q.dtype and OC.is_fake(o)
    assert m.shape == (2, 4) and OC.is_fake(m)
    fl, fo = c.kernels
    assert fl == {"name": "flash_attention", "dtype": "bfloat16",
                  "fake": True, "flops": 4.0 * 8 * 32 * 64 * 65 / 2,
                  "bytes": float((2 * 8 + 2 * 4) * 64 * 32 * 2)}
    assert fo["name"] == "isla_fold" and fo["fake"]
    assert fo["flops"] == 17.0 * 3000
    assert fo["bytes"] == 3000 * 4 + 16 + 2 * 2 * 16
    assert not any(k.startswith("aten.mm") or k.startswith("aten.bmm")
                   for k in c.ops)


def test_fake_branch_takes_no_real_tensor():
    """The fake branch is shape inference, never a fallback: a real CPU
    tensor runs the plain version (the real output; its ops not counted,
    the kernel's cost recorded as a launch's would be), and
    ``fake_kernel`` given any real tensor raises."""
    from repro_torch.kernels import ref
    q = torch.randn(4, 16, 32)
    with OC.CostCounter() as c:
        out = flash_attention(q, q, q)
    assert not OC.is_fake(out)
    assert torch.equal(out, ref.flash_attention_ref(q, q, q))
    assert [(k["name"], k["fake"]) for k in c.kernels] == [
        ("flash_attention", False)]
    assert list(c.ops) == ["kernel.flash_attention"]
    fm, f = _fake(4, 16, 32)
    with pytest.raises(ValueError, match="fake tensors only"):
        ops.fake_kernel("flash_attention", (f, q), f, 1.0, 1.0, q.dtype)
    with pytest.raises(ValueError, match="fake tensors only"):
        ops.fake_kernel("flash_attention", (f,), q, 1.0, 1.0, q.dtype)


def test_views_are_free_and_in_place_ops_count_once():
    x = torch.randn(64, 32)
    with OC.CostCounter() as c:
        y = x.t()[1:3].unsqueeze(0)
        x.view(-1).add_(1.0)
    assert c.cost.hbm_bytes == 2 * x.numel() * 4
    assert list(c.ops) == ["aten.add_"]
    assert y.shape == (1, 2, 64) and c.cost.flops == 0
