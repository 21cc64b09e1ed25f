"""The dry run (``repro_torch.launch.dryrun``) against the reference and
against real ranks.

The roofline functions (``core/costmodel.py``), the shape registry
(``configs/shapes.py``), the collective census (``launch/census.py``
against ``repro.launch.hlo_census`` on hand-written HLO lines), the model
FLOPs and each model rank's parameter bytes at M 16 equal the reference's
exactly.  The kernels' work equals the formulas ``chip_smoke.py`` held
before it took them from the kernels, and the flash pair count a
brute-force mask sum.  On ``meta`` the wrappers give the shapes and
dtypes of their plain versions on the CPU and launch nothing; a dry rank
counts the collectives, FLOPs and bytes that the same rank counts on real
CPU tensors over gloo (one spawn of 4 ranks: 2x1x2 and two 1x1x2 pairs).
"""
import dataclasses
import json
import math

import jax
import pytest
import torch

import _torch_ranks as ranks

from _torch_bridge import forked_ranks
from repro import configs as jconfigs
from repro.configs import shapes as JSH
from repro.core import costmodel as JCM
from repro.launch import hlo_census as JHC
from repro.models import sharding as JS
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.configs import shapes as SH
from repro_torch.core import costmodel as CM
from repro_torch.kernels import backend, work
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quant as kq
from repro_torch.kernels import wkv as kw
from repro_torch.launch import census as C
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.step import abstract_params
from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves

ARCHS = jconfigs.list_archs()
V5E = JCM.TPU_V5E
# the reference's TPU constants in the port's fields
PORT_V5E = CM.HW(name=V5E.name, peak_flops=V5E.peak_flops,
                 hbm_bw=V5E.hbm_bw, fast_bw=V5E.ici_bw, slow_bw=V5E.dcn_bw,
                 hbm_bytes=V5E.hbm_bytes, smem_bytes=V5E.vmem_bytes)


# ---------------------------------------------------------------------- #
# The roofline, the shapes, the census, the model FLOPs, the shards
# ---------------------------------------------------------------------- #

ROOF_ARGS = [(1.3e15, 2.1e12, 5.5e9, 256), (3e12, 9.7e13, 1.1e11, 512),
             (7e17, 1e9, 0.0, 16)]


@pytest.mark.parametrize("slow", [0.0, 3.2e8])
def test_roofline_terms_equal_reference(slow):
    for a in ROOF_ARGS:
        assert CM.roofline_terms(*a, hw=PORT_V5E, slow_bytes=slow) == \
            JCM.roofline_terms(*a, hw=V5E, dcn_bytes=slow)


@pytest.mark.parametrize("wall", [None, 2.5e-3])
def test_kernel_roofline_equals_reference(wall):
    for flops, nbytes in ((4.1e12, 3.3e9), (0.0, 5.2e8), (9e14, 1e6)):
        assert CM.kernel_roofline(flops, nbytes, hw=PORT_V5E, wall_s=wall) \
            == JCM.kernel_roofline(flops, nbytes, hw=V5E, wall_s=wall)
    with pytest.raises(ValueError):
        CM.kernel_roofline(1.0, 0.0)
    with pytest.raises(ValueError):
        CM.kernel_roofline(1.0, 1.0, wall_s=0.0)


def test_refit_hw_equals_reference_and_h100_is_the_datasheet():
    for f, b in ((0.41, 0.83), (1.7, -2.0), (1e-9, 1.0)):
        got = CM.refit_hw(PORT_V5E, flops_frac=f, bw_frac=b, name="fit")
        want = JCM.refit_hw(V5E, flops_frac=f, bw_frac=b, name="fit")
        assert (got.name, got.peak_flops, got.hbm_bw, got.fast_bw,
                got.slow_bw, got.hbm_bytes, got.smem_bytes) == \
            (want.name, want.peak_flops, want.hbm_bw, want.ici_bw,
             want.dcn_bw, want.hbm_bytes, want.vmem_bytes)
    assert (CM.H100.peak_flops, CM.H100.hbm_bw, CM.H100.fast_bw,
            CM.H100.slow_bw, CM.H100.hbm_bytes, CM.H100.smem_bytes) == \
        (989e12, 3.35e12, 450e9, 50e9, 80e9, 228 * 1024)
    assert CM.H100_F32 == dataclasses.replace(CM.H100, name="h100_f32",
                                              peak_flops=67e12)


def _spec(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_applicable_inputs_and_caches_equal_reference(arch):
    jc, c = jconfigs.get_config(arch), configs.get_config(arch)
    assert {k: dataclasses.astuple(v) for k, v in SH.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSH.SHAPES.items()}
    for name, shape in SH.SHAPES.items():
        assert SH.applicable(c, shape) == JSH.applicable(jc, JSH.SHAPES[name])
        got = {k: _spec(v) for k, v in SH.input_specs(c, shape).items()}
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                JSH.input_specs(jc, JSH.SHAPES[name]).items()}
        assert got == want and all(v.is_meta for v in
                                   SH.input_specs(c, shape).values())
        if shape.kind == "decode" and SH.applicable(c, shape)[0]:
            ours = SH.cache_specs(c, shape)
            ref = JSH.cache_specs(jc, JSH.SHAPES[name])
            assert [{k: _spec(v) for k, v in e.items()} for e in ours] == \
                [{k: (tuple(v.shape), str(v.dtype)) for k, v in e.items()}
                 for e in ref]


# iota replica groups and the explicit first group each stands for, on
# the 2x16x16 (pod, data, model) mesh: a model group, a data group, the
# pod pair, a dp group over both pods
GROUPS = [
    ("[32,16]<=[512]", list(range(16))),
    ("[32,16]<=[2,16,16]T(0,2,1)", list(range(0, 256, 16))),
    ("[256,2]<=[2,256]T(1,0)", [0, 256]),
    ("[16,32]<=[2,16,16]T(2,0,1)", list(range(0, 512, 16))),
]
KINDS = {"all-reduce": ("f32[1024,64]", 262144),
         "all-gather": ("bf16[4096,128]", 1048576),
         "reduce-scatter": ("f32[77,3]", 924),
         "all-to-all": ("s8[2048]", 2048)}


def _hlo(kind, shape, groups, i):
    return (f"  %{kind}.{i} = {shape}{{1,0}} {kind}({shape}{{1,0}} %p.{i}),"
            f" replica_groups={groups}, to_apply=%add")


@pytest.mark.parametrize("explicit", [False, True])
def test_census_equals_reference_on_hlo_lines(explicit):
    lines, records = ["ENTRY %main (p: f32[8]) -> f32[8] {"], []
    for i, (kind, (shape, nbytes)) in enumerate(KINDS.items()):
        for j, (iota, ranks) in enumerate(GROUPS):
            groups = "{{" + ",".join(map(str, ranks)) + "}}" if explicit \
                else iota
            lines.append(_hlo(kind, shape, groups, 4 * i + j))
            records.append({"kind": kind, "bytes": nbytes, "ranks": ranks})
    lines.append("}")
    want = JHC.census("\n".join(lines), 256)
    got = C.census(records, 256)
    assert got["fast_bytes"] == want["ici_bytes"] > 0
    assert got["slow_bytes"] == want["dcn_bytes"] > 0
    assert got["counts"] == {k.replace("/ici", "/fast").replace(
        "/dcn", "/slow"): n for k, n in want["counts"].items()}
    assert [(o["kind"], o["bytes"], o["group"], o["slow"])
            for o in got["ops"]] == [(o["kind"], o["bytes"], o["group"],
                                      o["dcn"]) for o in want["ops"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_model_gflops_and_rank_param_bytes_at_m16_equal_reference(arch):
    jc, c = jconfigs.get_config(arch), configs.get_config(arch)
    for name, shape in SH.SHAPES.items():
        tokens = shape.global_batch * (shape.seq_len if shape.kind !=
                                       "decode" else 1)
        mult = 6 if shape.kind == "train" else 2
        assert D.model_gflops(c, shape) == \
            mult * jc.active_param_count() * tokens / 1e9
    ref = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0), jc))
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    want = 0
    for leaf, spec in zip(jax.tree.leaves(ref), jax.tree.leaves(
            JS.param_pspecs(ref, 16), is_leaf=is_spec)):
        names = [n for e in spec for n in (e if isinstance(e, tuple)
                                           else (e,))]
        nbytes = math.prod(leaf.shape) * leaf.dtype.itemsize
        if "model" in names:
            dim = leaf.shape[names.index("model")]
            assert dim % 16 == 0
            nbytes //= 16
        want += nbytes
    for m in (0, 15):
        ours = tree_leaves(abstract_params(c, 16, m))
        assert all(t.is_meta for t in ours)
        assert sum(t.nbytes for t in ours) == want


# ---------------------------------------------------------------------- #
# The kernels' work
# ---------------------------------------------------------------------- #

def _mask_sum(Sq, Sk, causal, window, q_offset):
    qp = q_offset + torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    return int(mask.sum())


@pytest.mark.parametrize("Sq,Sk,q_offset", [
    (512, 512, 0), (777, 777, 0), (1, 2048, 2047), (512, 2048, 1536),
    (300, 100, 0), (100, 300, 0), (64, 64, 500), (33, 65, 7)])
@pytest.mark.parametrize("causal,window", [
    (True, None), (False, None), (True, 1), (True, 17), (True, 512),
    (False, 40), (True, 5000)])
def test_flash_pairs_equal_a_mask_sum(Sq, Sk, q_offset, causal, window):
    assert fa.pairs(Sq, Sk, causal, window, q_offset) == \
        _mask_sum(Sq, Sk, causal, window, q_offset)


# (B, Sq, Sk, H, Hkv, hd, causal, window, q_offset, esz): chip_smoke's
FLASH_SHAPES = [(1, 512, 512, 12, 12, 64, True, None, 0, 2),
                (2, 777, 777, 32, 8, 128, True, None, 0, 4),
                (1, 2048, 2048, 16, 8, 256, True, 1024, 0, 2),
                (1, 512, 2048, 12, 12, 64, True, None, 1536, 2),
                (4, 128, 512, 16, 16, 64, False, None, 0, 2),
                (1, 4096, 4096, 10, 1, 256, True, 2048, 0, 4)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_work_equals_the_old_chip_smoke_formulas(shape):
    B, Sq, Sk, H, Hkv, hd, causal, window, q_offset, esz = shape
    n = _mask_sum(Sq, Sk, causal, window, q_offset)
    q = o = B * Sq * H * hd
    k = v = B * Sk * Hkv * hd
    lse = B * H * Sq
    kw_ = dict(causal=causal, window=window, q_offset=q_offset, esz=esz)
    dims = (B, Sq, Sk, H, Hkv, hd)
    assert fa.fwd_work(*dims, **kw_) == (
        4.0 * B * H * hd * n, (q + k + v + o) * esz + lse * 4)
    ins = (2 * q + k + v) * esz + 2 * lse * 4
    assert fa.bwd_dq_work(*dims, **kw_) == (6.0 * hd * B * H * n,
                                            ins + q * esz)
    assert fa.bwd_dkv_work(*dims, **kw_) == (8.0 * hd * B * H * n,
                                             ins + 2 * k * esz)


def test_quant_and_wkv_work_equal_the_old_chip_smoke_formulas():
    old = {"quantize_int8": 4 + 1 + 4 / 256,
           "dequantize_int8": 1 + 4 / 256 + 4,
           "quantize_ef_int8": 4 + 4 + 1 + 4 / 256 + 4}
    for name, per in old.items():
        for n in (256, 54_765_568, 3 * 131072):
            assert kq.work(name, n) == (0.0, per * n)

    def wkv_work(B, S, H, hd, C=16):
        per_chunk = 4 * C * hd * hd + 2 * C * (C - 1) * hd + 2 * hd * hd \
            + 12 * C * hd
        return (B * H * (S // C) * per_chunk,
                4 * (5 * B * S * H * hd + B * H * hd * hd + H * hd))
    for shape in ((8, 512, 32, 64), (1, 304, 32, 64), (2, 64, 2, 16)):
        assert kw.work(*shape) == wkv_work(*shape)


# ---------------------------------------------------------------------- #
# The wrappers on meta, the device, the refusals
# ---------------------------------------------------------------------- #

def _meta(*ts):
    return [t.to("meta") for t in ts]


def _same(got, want):
    got, want = tree_leaves(got), tree_leaves(want)
    assert [(_spec(g), g.device.type) for g in got] == \
        [(_spec(w), "meta") for w in want]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_on_meta_give_the_plain_shapes_and_launch_nothing(dtype):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 40, 6, 16), generator=g).to(dtype)
    k, v = (torch.randn((2, 72, 3, 16), generator=g).to(dtype)
            for _ in range(2))
    kwm = dict(causal=True, window=9, q_offset=32)
    o, lse = fa.flash_attention_fwd(q, k, v, **kwm)
    _same(fa.flash_attention_fwd(*_meta(q, k, v), **kwm), (o, lse))
    do = torch.randn(q.shape, generator=g).to(dtype)
    _same(fa.flash_attention_bwd(*_meta(q, k, v, o, lse, do), **kwm),
          fa.flash_attention_bwd(q, k, v, o, lse, do, **kwm))
    x, ef = (torch.randn(1000, generator=g) for _ in range(2))
    q8, s, pad = kq.quantize_int8(x)
    got = kq.quantize_int8(x.to("meta"))
    _same(got[:2], (q8, s))
    assert got[2] == pad
    _same(kq.dequantize_int8(*_meta(q8, s), pad),
          kq.dequantize_int8(q8, s, pad))
    want = kq.quantize_ef_int8(x, ef)
    got = kq.quantize_ef_int8(*_meta(x, ef))
    _same(got[:3], want[:3])
    assert got[3] == want[3]
    r, kk, vv, w = (torch.rand((1, 32, 2, 8), generator=g)
                    for _ in range(4))
    u = torch.rand((2, 8), generator=g)
    for state in (False, True):
        _same(kw.wkv_chunked(*_meta(r, kk, vv, w, u), return_state=state),
              kw.wkv_chunked(r, kk, vv, w, u, return_state=state))
    assert (fa.flash_attention_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches, kq.quantize_int8.launches,
            kq.dequantize_int8.launches, kq.quantize_ef_int8.launches,
            kw.wkv_chunked.launches) == (0,) * 7


def test_a_counter_takes_each_kernel_by_its_work_on_cpu_and_meta():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 64, 4, 16), generator=g) for _ in range(3))
    for t in ((q, k, v), _meta(q, k, v)):
        with work.WorkCounter() as wc:
            fa.flash_attention_fwd(*t)
        assert wc.flops == fa.fwd_work(1, 64, 64, 4, 4, 16, esz=4)[0]
        assert wc.kernels["flash_fwd"] == {
            "launches": 1, "flops": wc.flops, "bytes": wc.bytes}
    with work.WorkCounter() as wc:
        with work.quiet():
            q @ k.transpose(-1, -2)
    assert wc.flops == wc.bytes == 0


def test_devices_meta_is_asked_for_and_cuda_still_raises():
    assert backend.resolve_device("meta") == torch.device("meta")
    assert backend.on_card(torch.empty(1, device="meta"))
    assert not backend.on_card(torch.empty(1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            backend.resolve_device("cuda")
    with pytest.raises(ValueError):
        backend.resolve_device("xpu")


def test_refusals_are_the_references_and_tp_checks():
    """The only cells skipped are the reference's; a model axis refuses
    none (rwkv6-1.6b on 16x64 cuts its columns inside its heads and is
    recorded, as its two rank programs)."""
    got = D.lower_cell("rwkv6-1.6b", "decode_32k", False, mesh=(1, 16, 64))
    assert "skipped" not in got and RECORD_KEYS <= set(got)
    assert len(got["per_rank"]) == 2
    for arch, shape in (("qwen3-4b", "long_500k"), ("gpt-100m",
                                                    "long_500k")):
        jc = jconfigs.get_config(arch)
        assert D.lower_cell(arch, shape, True) == {
            "skipped": JSH.applicable(jc, JSH.SHAPES[shape])[1]}


def test_a_cell_at_m3_is_recorded_through_the_fallbacks():
    """gemma3-12b's decode_32k on 16x3, where M 3 divides neither its 4096
    query columns nor its 262,144 vocabulary rows: ``wq``/``wk``/``wv``
    by rows (one all-reduce a layer), ``wo`` by columns (one all-gather),
    the MLP by features (one all-reduce), the embedding and head whole;
    every rank computes every head, so one rank's run stands for all."""
    got = D.lower_cell("gemma3-12b", "decode_32k", False, mesh=(1, 16, 3))
    assert RECORD_KEYS <= set(got) and got["mesh"] == "16x3"
    n = configs.get_config("gemma3-12b").n_layers
    assert got["collective_counts"] == {"all-reduce/fast": 2 * n,
                                        "all-gather/fast": n}
    assert [p["members"] for p in got["per_rank"].values()] == [[0, 1, 2]]


RECORD_KEYS = {"arch", "shape", "mesh", "comm_mode", "zero1", "trace_s",
               "bytes_per_device", "gflops", "gbytes", "fast_mb_per_chip",
               "slow_mb_per_chip", "collective_counts", "model_gflops",
               "useful_flops_frac", "compute_s", "memory_s", "collective_s",
               "bound", "step_s", "hw", "rank", "memory"}


def test_the_cli_touches_no_cuda_and_writes_every_key(tmp_path,
                                                      monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the dry run touched torch.cuda")
    for name in ("is_available", "device_count", "current_device",
                 "get_device_capability", "get_device_name", "init"):
        monkeypatch.setattr(torch.cuda, name, boom)
    out = tmp_path / "d.json"
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "olmoe-1b-7b", "--shape", "decode_32k", "--mesh",
                "both", "--out", str(out)])
    assert e.value.code == 0
    res = json.loads(out.read_text())
    assert set(res) == {f"olmoe-1b-7b|decode_32k|{m}|multilevel"
                        for m in ("16x16", "2x16x16")}
    for key, rec in res.items():
        assert RECORD_KEYS <= set(rec) and rec["moe_sizes"] == "even"
        assert rec["mesh"] == key.split("|")[2] and rec["hw"] == "h100"
        mem = rec["memory"]
        assert rec["bytes_per_device"] == mem["output_bytes"] + \
            mem["temp_bytes"] + mem["argument_bytes"] - mem["alias_bytes"]
        assert mem["alias_bytes"] > 0        # the cache, updated in place
    assert res["olmoe-1b-7b|decode_32k|2x16x16|multilevel"][
        "collective_counts"] == res["olmoe-1b-7b|decode_32k|16x16|"
                                    "multilevel"]["collective_counts"]
    assert not torch.cuda.is_initialized()


def test_even_moe_shares_sum_to_the_routed_rows():
    for n, E in ((8 * 4096, 64), (4, 16), (8193, 16), (0, 8)):
        s = L.even_sizes(n, E)
        assert sum(s) == n and max(s) - min(s) <= (1 if n % E else 0)


# ---------------------------------------------------------------------- #
# The dry run against real ranks
# ---------------------------------------------------------------------- #

def _cut_cfg():
    """gpt-100m's smoke config with 3 heads and 3 KV heads: a model axis
    of 2 or 4 cuts inside a head and its KV heads by columns."""
    return dataclasses.replace(configs.get_config("gpt-100m", smoke=True),
                               n_heads=3, n_kv_heads=3)


CASES = [
    ("gpt", configs.get_config("gpt-100m", smoke=True), (2, 1, 2), 512, 4,
     "multilevel_compress", True),
    ("cut", _cut_cfg(), (1, 1, 2), 512, 2, "multilevel", True),
    ("cut_flat", _cut_cfg(), (2, 1, 2), 512, 4, "flat", False),
    ("rwkv", configs.get_config("rwkv6-1.6b", smoke=True), (1, 1, 2), 512,
     2, "multilevel", True),
]


@pytest.fixture(scope="module")
def real():
    return run_ranks(ranks.dry_counts, 4, "gloo", (CASES,), timeout=600)


def _dry(cfg, mesh, S, B, comm, zero1, m):
    pods, data, model = mesh
    out = {}
    for kind, shape in (("train", SH.ShapeSpec("t", "train", S, B)),
                        ("prefill", SH.ShapeSpec("p", "prefill", S, B)),
                        ("decode", SH.ShapeSpec("d", "decode", 2 * S, B))):
        r = D.run_rank(cfg, shape, pods, data, model, m, comm, zero1)
        out[kind] = {"calls": {a: [c["calls"], c["bwd_calls"],
                                   c["wire_bytes"]]
                               for a, c in r["calls"].items()},
                     "flops": r["flops"], "bytes": r["bytes"],
                     "kernels": r["kernels"]}
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dry_ranks_count_what_real_ranks_count(real, case):
    """Per model rank of the (pod 0, data 0) cell: the calls, backward
    calls and wire bytes of every axis, the FLOPs, bytes and kernels'
    work of a train step, a prefill and a decode step, exactly."""
    name, cfg, mesh, S, B, comm, zero1 = case
    for m in range(mesh[2]):
        want = real[m][name]
        got = _dry(cfg, mesh, S, B, comm, zero1, m)
        for kind in ("train", "prefill", "decode"):
            assert got[kind]["calls"] == want[kind]["calls"], (kind, m)
            assert got[kind]["kernels"] == want[kind]["kernels"], (kind, m)
            assert (got[kind]["flops"], got[kind]["bytes"]) == \
                (want[kind]["flops"], want[kind]["bytes"]), (kind, m)
        assert got["train"]["calls"]["model"][1] > 0


def test_ranks_of_one_key_give_one_record():
    """Every rank of a cut config on 1x1x4 run on its own: the ranks that
    ``rank_key`` puts together give the same record."""
    cfg = _cut_cfg()
    shape = SH.ShapeSpec("t", "train", 512, 2)
    rec = D.dry_cell(cfg, shape, 1, 1, 4, every_rank=True)
    keys = {m: D.rank_key(cfg, shape, 1, 4, m) for m in range(4)}
    assert len(set(keys.values())) > 1
    strip = lambda r: {k: v for k, v in r.items()
                       if k not in ("members", "trace_s")}
    for a in range(4):
        for b in range(4):
            if keys[a] == keys[b]:
                assert strip(rec["per_rank"][a]) == strip(rec["per_rank"][b])
    one = D.dry_cell(cfg, shape, 1, 1, 4)
    assert sorted(m for p in one["per_rank"].values()
                  for m in p["members"]) == [0, 1, 2, 3]
    assert {k: one[k] for k in ("bytes_per_device", "gflops", "step_s")} \
        == {k: rec[k] for k in ("bytes_per_device", "gflops", "step_s")}
