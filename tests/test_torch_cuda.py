"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper card and skip elsewhere; on the machine
with the card run them with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  This file imports no JAX: the card's machine
has none.  The plain versions are checked against JAX on the CPU in
``tests/test_torch_flash.py``.

Tolerances: 3e-5 (f32) and 2e-2 (bf16) absolute on the forward, the JAX
kernel tests' own; 1e-4 (f32) and 2e-2 (bf16) times max|ref| on the
backward, as ``chip_smoke.py`` holds them.  The kernels sum in another
order than the plain versions, and bf16 outputs may round to the
neighbouring value.  The bf16 kernels are also held to the plain versions
that mirror their bf16 rounding of P (forward, dk/dv) and dS (backward),
under 4e-3 times max|ref|: those versions return f32, so what is left is
the kernels' own rounding of o, dq, dk and dv to bf16 (half an ulp, at
most 2**-8 = 3.9e-3 of max|ref|) and f32 sums in another order; the
forward's lse, which is not rounded, is held to its mirror within 1e-4
times max(1, max|lse|).  TF32 is off for the plain
versions' f32 einsums.  The int8 kernels equal their plain versions bit
for bit (NaN where NaN), and so does ``apply_error_feedback`` on the
card against its plain path on the CPU.  The MoE, RG-LRU, enc-dec and
vision configs in f32 agree with the CPU within 1e-4 on logits and f32
cache leaves, one bf16 ulp on bf16 ones.  The WKV kernel's o and final state agree with
its plain version within 1e-4 times max(1, max|ref|), as
``chip_smoke.py`` holds it; the RWKV-6 model in f32 on the card agrees
with the CPU within 1e-4 on logits and state, and one bf16 ulp on the
bf16 rows it carries; its training step's loss and gradients within 1e-4
(``wkv``'s backward is the plain scan's autograd on the card, equal to
that graph's own gradients bit for bit).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import compression as C
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quant as kq
from repro_torch.kernels import wkv as kw
from repro_torch.launch.serve import serve
from repro_torch.launch.step import (device_batch, loss_and_grads,
                                     make_decode_fn, make_prefill_fn)
from repro_torch.launch.train import train
from repro_torch.models import transformer as T
from repro_torch.serving import ReqState
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, Sq, Sk, H, Hkv, hd, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        dev, dtype)
    return mk(B, Sq, H, hd), mk(B, Sk, Hkv, hd), mk(B, Sk, Hkv, hd)


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MIRROR_TOL = 4e-3      # bf16 kernels against their mirror (module docstring)
LSE_MIRROR_TOL = 1e-4


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,causal,window,q_offset", [
    (1, 512, 512, 12, 12, 64, True, None, 0),      # gpt-100m prefill
    (2, 777, 777, 8, 2, 64, True, None, 0),        # ragged, GQA
    (1, 256, 256, 32, 4, 64, True, None, 0),       # tinyllama groups
    (1, 300, 300, 8, 2, 128, True, None, 0),       # qwen3 head dim
    (1, 200, 333, 4, 4, 32, False, None, 0),       # non-causal, Sq != Sk
    (1, 384, 384, 4, 2, 64, True, 100, 0),         # sliding window
    (1, 128, 384, 4, 1, 64, True, None, 256),      # continuation chunk
    (1, 128, 256, 4, 2, 16, True, 64, 300),        # fully masked rows
    (1, 96, 96, 6, 2, 256, True, None, 0),
    (1, 300, 300, 10, 1, 256, True, 128, 0),       # recurrentgemma: G = 10
    (1, 512, 512, 16, 16, 128, True, None, 0),     # olmoe prefill
    (1, 2048, 2048, 10, 1, 256, True, 2048, 0),    # recurrentgemma local
    (1, 2048, 2048, 5, 1, 256, True, 2048, 0),     # its rank at M 2: G 5
    (4, 512, 512, 16, 16, 64, False, None, 0),     # seamless encoder
    (4, 128, 512, 16, 16, 64, False, None, 0),     # seamless cross
    (4, 512, 512, 32, 8, 128, True, None, 0),      # pixtral
    (4, 512, 512, 40, 8, 128, True, None, 0),      # llama4-scout: G = 5
    # head dims between the tile widths: 80 (phi-2), 96 (phi-3-mini), 100
    # (8-byte aligned rows), 48, 33 (odd), 200 (width 224)
    (1, 2048, 2048, 32, 32, 80, True, None, 0),
    (1, 2048, 2048, 32, 32, 96, True, None, 0),
    (2, 333, 333, 8, 2, 100, True, 100, 0),
    (1, 300, 300, 8, 8, 48, True, None, 0),
    (1, 128, 384, 4, 1, 33, True, None, 256),
    (1, 300, 300, 10, 1, 200, True, 128, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(dev, B, Sq, Sk, H, Hkv, hd, causal,
                                    window, q_offset, dtype):
    q, k, v = _inputs(B, Sq, Sk, H, Hkv, hd, dtype, dev)
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_fwd_ref(
        q, k, v, causal=causal, window=window, q_offset=q_offset)
    tol = 2e-2 if dtype == torch.bfloat16 else 3e-5
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=tol, rtol=1e-6)
    if dtype == torch.bfloat16:
        o_m, lse_m = fa.flash_attention_fwd_bf16_ref(
            q, k, v, causal=causal, window=window, q_offset=q_offset)
        torch.testing.assert_close(
            o.float(), o_m, rtol=0,
            atol=MIRROR_TOL * o_m.abs().max().item())
        torch.testing.assert_close(
            lse, lse_m, rtol=1e-6,
            atol=LSE_MIRROR_TOL * max(1.0, lse_m.abs().max().item()))


def test_flash_kernel_rejects_what_it_cannot_take(dev):
    # every head dim up to 256 runs (48 against its plain version); 257
    # and 512 are refused
    q, k, v = _inputs(1, 64, 64, 4, 2, 48, torch.float32, dev)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v)
    torch.testing.assert_close(o, o_ref, atol=3e-5, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=3e-5, rtol=1e-6)
    for hd in (257, 512):
        q, k, v = _inputs(1, 64, 64, 4, 2, hd, torch.float32, dev)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention_fwd(q, k, v)
    q, k, v = _inputs(1, 64, 64, 4, 2, 64, torch.float16, dev)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_fwd(q, k, v)
    # bf16 rows are staged with 16-byte copies: a contiguous view that
    # starts 2 bytes into its storage is refused
    qkv = _inputs(1, 64, 64, 4, 2, 64, torch.bfloat16, dev)
    for i, t in enumerate(qkv):
        args = list(qkv)
        args[i] = torch.zeros(t.numel() + 1, device=dev,
                              dtype=t.dtype)[1:].view(t.shape)
        with pytest.raises(ValueError, match="aligned"):
            fa.flash_attention_fwd(*args)


def _f32(params, device):
    if isinstance(params, dict):
        return {k: _f32(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [_f32(v, device) for v in params]
    return params.float().to(device)


@pytest.mark.parametrize("arch,S", [("gpt_100m", 40), ("qwen3_4b", 64)])
def test_prefill_on_card_matches_cpu(dev, arch, S):
    """The whole prefill in f32, the card (flash kernel at any length)
    against the CPU (the reference's dispatch): logits within 1e-4."""
    cfg = get_config(arch, smoke=True)
    params = T.init_model(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, S),
                         generator=torch.Generator().manual_seed(0))
    want, _, _ = T.prefill(_f32(params, "cpu"), cfg, {"tokens": toks}, S)
    got, _, _ = T.prefill(_f32(params, dev), cfg, {"tokens": toks.to(dev)},
                          S)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


NEW_ARCHS = ["llama4_scout_17b_a16e", "olmoe_1b_7b", "pixtral_12b",
             "recurrentgemma_2b", "seamless_m4t_medium"]


def _leaves_close(got, want):
    """f32 cache leaves within 1e-4 of their scale, bf16 ones within one
    bf16 ulp."""
    for eg, ec in zip(got, want):
        for name, b in ec.items():
            a = eg[name].cpu()
            if b.dtype == torch.float32:
                top = b.abs().max().item()
                torch.testing.assert_close(a, b, atol=1e-4 * top, rtol=0)
            else:
                torch.testing.assert_close(a.float(), b.float(),
                                           rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_archs_on_card_match_cpu(dev, arch):
    """MoE, RG-LRU, enc-dec and the vision prefix at smoke size in f32: the
    prefill and 3 dense decode steps, each from the CPU's cache and token,
    on the card against the CPU: logits within 1e-4, cache leaves as
    ``_leaves_close``; the flash kernel launched once per attention layer
    (encoder and cross layers included) of the prefill."""
    cfg = get_config(arch, smoke=True)
    params = _f32(T.init_model(cfg, seed=0, device="cpu"), "cpu")
    p_dev = _f32(params, dev)
    gen = torch.Generator().manual_seed(0)
    inputs = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=gen)}
    if cfg.frontend:
        e = torch.randn((2, 4, cfg.d_model), generator=gen)
        inputs["src_embeds" if cfg.enc_dec else "embeds"] = \
            e.to(torch.bfloat16)
    prefill, decode = make_prefill_fn(cfg, 24), make_decode_fn(cfg)
    lg_c, cache_c, pos = prefill(params, inputs)
    before = fa.flash_attention_fwd.launches
    lg_g, cache_g, _ = prefill(p_dev, {k: v.to(dev)
                                       for k, v in inputs.items()})
    n_attn = sum(k in ("attn", "local") for k in cfg.pattern)
    enc = cfg.enc_dec.n_enc_layers + n_attn if cfg.enc_dec else 0
    assert fa.flash_attention_fwd.launches - before == n_attn + enc
    torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
    _leaves_close(cache_g, cache_c)
    for i in range(3):
        tok = lg_c[:, -1].argmax(-1, keepdim=True)
        start = [{k: t.to(dev, copy=True) for k, t in e.items()}
                 for e in cache_c]
        lg_c, cache_c = decode(params, cache_c, tok, pos + i)
        lg_g, cache_g = decode(p_dev, start, tok.to(dev), pos + i)
        torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
        _leaves_close(cache_g, cache_c)


def test_olmoe_serve_on_card(dev):
    """The paged serve of the MoE on the card: every request done, one
    flash launch per layer and prefill, one host read of the group sizes
    per MoE layer and model call."""
    from repro_torch.models import layers as L
    cfg = get_config("olmoe_1b_7b", smoke=True)
    fa.flash_attention_fwd.launches = 0
    L.moe_fwd.host_syncs = 0
    out = serve("olmoe-1b-7b", 3, 21, 5, smoke=True, device="cuda")
    assert all(r.state is ReqState.DONE for r in out["requests"])
    assert out["generated"].shape == (3, 5)
    assert fa.flash_attention_fwd.launches == cfg.n_layers * out["prefills"]
    assert L.moe_fwd.host_syncs % cfg.n_layers == 0
    assert L.moe_fwd.host_syncs >= cfg.n_layers * out["prefills"]


def _serve_on_a_model_axis(arch):
    cfg = get_config(arch, smoke=True)
    one = serve(arch, 3, 21, 5, smoke=True, device="cuda")
    two = serve(arch, 3, 21, 5, "1x1x2", smoke=True, device="cuda")
    assert all(r.state is ReqState.DONE for r in two["requests"])
    np.testing.assert_array_equal(two["generated"], one["generated"])
    np.testing.assert_allclose(two["first_logits"], one["first_logits"],
                               atol=5e-2, rtol=0)
    ax = two["model_axis"]
    assert ax["flash_fwd_launches"] == [cfg.n_layers * two["prefills"]] * 2
    assert all(b > 0 for b in ax["staged_bytes"])


def test_serve_on_a_model_axis_on_card(dev):
    """``serve --mesh 1x1x2`` on the card: two gloo ranks share it, each
    with its shard and its heads (the flash kernel on 2 of gpt-100m's 4
    smoke heads, one launch a layer and prefill on each rank), their
    collectives staged through host memory; the tokens are the one-rank
    serve's and the first prefill's bf16 logits within 5e-2 of its."""
    _serve_on_a_model_axis("gpt-100m")


def test_kv_head_split_served_paged_on_card(dev):
    """qwen3-4b's smoke config, whose one KV head the two ranks share
    (``wk``/``wv`` cut inside it, k and v gathered), through the paged
    ``serve --mesh 1x1x2`` on the card, as the test above holds
    gpt-100m: the flash kernel on 2 query heads and the one KV head a
    rank, the pools holding that head on each rank."""
    _serve_on_a_model_axis("qwen3-4b")


def test_serve_on_card_launches_the_kernel(dev):
    cfg = get_config("qwen3_4b", smoke=True)
    fa.flash_attention_fwd.launches = 0
    out = serve("qwen3-4b", 3, 21, 5, smoke=True, device="cuda")
    assert all(r.state is ReqState.DONE for r in out["requests"])
    assert out["generated"].shape == (3, 5)
    assert fa.flash_attention_fwd.launches == cfg.n_layers * out["prefills"]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,causal,window,q_offset", [
    (8, 1024, 1024, 12, 12, 64, True, None, 0),    # gpt-100m training
    (1, 512, 512, 12, 12, 64, True, None, 0),
    (2, 777, 777, 8, 2, 64, True, None, 0),        # ragged, GQA
    (1, 256, 256, 32, 4, 64, True, None, 0),       # tinyllama groups
    (1, 300, 300, 8, 2, 128, True, None, 0),       # qwen3 head dim
    (1, 200, 333, 4, 4, 32, False, None, 0),       # non-causal, Sq != Sk
    (1, 384, 384, 4, 2, 64, True, 100, 0),         # sliding window
    (1, 128, 384, 4, 1, 64, True, None, 256),      # continuation chunk
    (1, 128, 256, 4, 2, 16, True, 64, 300),        # fully masked rows
    (1, 96, 96, 6, 3, 32, True, None, 0),          # G = 3 leaves a row idle
    # hd 256: the bf16 column split and the f32 32-key tile
    (1, 512, 512, 10, 1, 256, True, 128, 0),       # recurrentgemma: G 10
    (1, 2048, 2048, 5, 1, 256, True, 2048, 0),     # its rank at M 2: G 5
    (2, 333, 333, 8, 1, 256, True, None, 0),       # ragged, G 8
    (1, 300, 300, 16, 8, 256, True, 100, 0),       # gemma3 local, G 2
    (1, 128, 384, 4, 4, 256, True, None, 256),     # continuation, G 1
    (1, 200, 300, 2, 2, 256, False, None, 0),      # non-causal, G 1
    # head dims between the tile widths (test_flash_kernel_matches_plain)
    (1, 2048, 2048, 32, 32, 80, True, None, 0),
    (1, 2048, 2048, 32, 32, 96, True, None, 0),
    (2, 333, 333, 8, 2, 100, True, 100, 0),
    (1, 300, 300, 8, 8, 48, True, None, 0),
    (1, 128, 384, 4, 1, 33, True, None, 256),
    (1, 300, 300, 10, 1, 200, True, 128, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain(dev, B, Sq, Sk, H, Hkv, hd, causal,
                                       window, q_offset, dtype):
    q, k, v = _inputs(B, Sq, Sk, H, Hkv, hd, dtype, dev)
    do = _inputs(B, Sq, Sq, H, H, hd, dtype, dev, seed=1)[0]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        assert torch.isfinite(g.float()).all()
        tol = BWD_TOL[dtype] * w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)
    if dtype == torch.bfloat16:
        delta = fa._delta(o, do, lse)
        mirror = (fa.flash_bwd_dq_bf16_ref(q, k, v, do, lse, delta, **kw),
                  *fa.flash_bwd_dkv_bf16_ref(q, k, v, do, lse, delta, **kw))
        for g, w in zip(got, mirror):
            tol = MIRROR_TOL * w.abs().max().item()
            torch.testing.assert_close(g.float(), w, atol=tol, rtol=0)


def test_flash_autograd_on_card_matches_cpu(dev):
    """FlashAttention under autograd, the card's kernels against the CPU's
    plain versions on the same f32 inputs, with a non-contiguous do."""
    q, k, v = _inputs(2, 300, 300, 8, 2, 64, torch.float32, "cpu")
    w = torch.randn(2, 8, 300, 64, generator=torch.Generator().manual_seed(2))
    grads = []
    for d in ("cpu", dev):
        leaves = [t.to(d).requires_grad_(True) for t in (q, k, v)]
        o = fa.flash_attention(*leaves)
        loss = (o * w.to(d).transpose(1, 2)).sum()   # do is a transpose
        grads.append([g.cpu() for g in torch.autograd.grad(loss, leaves)])
    for g, want in zip(*grads):
        torch.testing.assert_close(g, want, rtol=0,
                                   atol=1e-4 * want.abs().max().item())


def test_flash_bwd_rejects_what_it_cannot_take(dev):
    # hd 48 runs against its plain version; 257 and 512 are refused
    q, k, v = _inputs(1, 64, 64, 4, 2, 48, torch.float32, dev)
    do = _inputs(1, 64, 64, 4, 4, 48, torch.float32, dev, seed=1)[0]
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * w.abs().max().item())
    for hd, G, dtype in ((512, 1, torch.float32), (257, 1, torch.float32),
                         (64, 1, torch.float16), (64, 128, torch.float32)):
        q = torch.zeros(1, 64, G, hd, device=dev, dtype=dtype)
        k = torch.zeros(1, 64, 1, hd, device=dev, dtype=dtype)
        lse = torch.zeros(1, 1, G, 64, device=dev)
        with pytest.raises(ValueError):
            fa.flash_attention_bwd(q, k, k, q, lse, q)
    q = torch.zeros(1, 64, 2, 64, device=dev)
    k = torch.zeros(1, 64, 2, 64, device=dev)
    lse = torch.zeros(1, 2, 1, 64, device=dev)
    with pytest.raises(ValueError):                  # o on another device
        fa.flash_attention_bwd(q, k, k, q.cpu(), lse, q)
    # bf16 rows are staged with 16-byte copies: a contiguous view that
    # starts 2 bytes into its storage is refused
    q = torch.zeros(64 * 2 * 64 + 1, device=dev,
                    dtype=torch.bfloat16)[1:].view(1, 64, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_bwd(q, k.bfloat16(), k.bfloat16(), q, lse, q)


def test_train_on_card_matches_cpu(dev):
    """gpt-100m smoke in f32: loss and gradients on the card (flash kernels
    at S 512) against the CPU (their plain versions)."""
    cfg = get_config("gpt_100m", smoke=True)
    params = _f32(T.init_model(cfg, seed=0, device="cpu"), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 513))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = [loss_and_grads(_f32(params, d), cfg, device_batch(batch, d))
           for d in ("cpu", dev)]
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out
    assert abs(l_gpu.item() - l_cpu.item()) <= 1e-5 * abs(l_cpu.item())
    for lay_c, lay_g in zip(g_cpu["layers"], g_gpu["layers"]):
        want, got = lay_c["attn"]["wq"], lay_g["attn"]["wq"].cpu()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-3 * want.abs().max().item())


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_family_train_step_on_card_matches_cpu(dev, arch):
    """One f32 step of ``make_train_step`` of each family at smoke size
    (2 x 64 tokens: the flash kernels on the card, recurrentgemma's local
    layers at the window) against the CPU from the same weights: the loss
    within 1e-5 relative and Adam's first moment (0.1 x the clipped
    gradient) within 1e-4 of each leaf's largest, the CPU tests' f32
    gradient tolerance; a backward launch per attention call."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.step import make_train_step
    from repro_torch.models.convert import stack_runs
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.tree import tree_paths

    cfg = get_config(arch, smoke=True)
    full = stack_runs(_f32(T.init_model(cfg, seed=0, device="cpu"), "cpu"),
                      cfg)
    batch = DataPipeline(cfg, ShapeSpec("t", "train", 64, 2)).host_batch(0)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=1)
    out = {}
    for d in ("cpu", dev):
        params = _f32(full, d)
        before = fa.flash_bwd_dkv.launches
        _, opt, loss = make_train_step(cfg, opt_cfg, device=d)(
            params, init_opt_state(params, opt_cfg), batch)
        out[str(d)] = (loss.item(), [(k, m.cpu()) for k, m in
                                     tree_paths(opt["m"])],
                       fa.flash_bwd_dkv.launches - before)
    (l_c, m_c, n_c), (l_g, m_g, n_g) = out["cpu"], out[str(dev)]
    calls = sum(k in ("attn", "local") for k in cfg.pattern)
    if cfg.enc_dec:                     # the encoder's and cross layers
        calls += cfg.enc_dec.n_enc_layers + calls
    assert n_c == 0 and n_g == calls
    assert abs(l_g - l_c) <= 1e-5 * abs(l_c)
    top = max(c.abs().max().item() for _, c in m_c)
    for (name, g), (_, c) in zip(m_g, m_c):
        if cfg.moe is not None and cfg.moe.top_k == 1 \
                and name.endswith("router"):
            # a top-1 gate renormalises to 1: a zero gradient but for
            # rounding on each side
            assert max(g.abs().max().item(), c.abs().max().item()) \
                <= 1e-6 * top
        else:
            torch.testing.assert_close(g, c, rtol=0,
                                       atol=1e-4 * c.abs().max().item())


def test_launch_train_on_card(dev):
    cfg = get_config("gpt_100m")
    for f in (fa.flash_attention_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        f.launches = 0
    out = train("gpt-100m", steps=2, seq=512, batch=2, device="cuda")
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    n = cfg.n_layers * 2
    assert fa.flash_attention_fwd.launches == 2 * n   # remat recomputes
    assert fa.flash_bwd_dq.launches == fa.flash_bwd_dkv.launches == n


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na].view(torch.int32),
                                               b[~nb].view(torch.int32))


def _quant_input(n, dev, special=None, seed=0):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal(n)).astype(np.float32)
    if n >= 768:
        x[256:512] = np.arange(256) % 20 - 9.5       # ties at scale 1
        x[256] = 127.0
        x[512:768] = 0.0
    if special == "nan":
        x[300] = np.nan
    elif special == "inf":
        x[700] = np.inf
    elif special == "f32max":
        x[0], x[600] = C.F32_MAX, -C.F32_MAX
    ef = (0.05 * rng.standard_normal(n)).astype(np.float32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(ef).to(dev)


@pytest.mark.parametrize("n,special", [
    (256, None), (C.QTILE, None), (3 * C.QTILE - 100, None), (333, None),
    (1_000_003, None), (1024, "nan"), (1024, "inf"), (1024, "f32max")])
def test_quant_kernels_match_plain(dev, n, special):
    x, ef = _quant_input(n, dev, special)
    xp, _ = C.pad_to_block(x, C.QTILE)
    efp, _ = C.pad_to_block(ef, C.QTILE)
    before = [f.launches for f in (kq.quantize_int8, kq.dequantize_int8,
                                   kq.quantize_ef_int8)]
    q, s, pad = kq.quantize_int8(x)
    d = kq.dequantize_int8(q, s, pad)
    qe, se, re, pad_e = kq.quantize_ef_int8(x, ef)
    torch.cuda.synchronize()
    assert [f.launches for f in (kq.quantize_int8, kq.dequantize_int8,
                                 kq.quantize_ef_int8)] == \
        [b + 1 for b in before]
    assert pad == pad_e == (-n) % C.QTILE and d.numel() == re.numel() == n
    qr, sr = kq.quantize_int8_ref(xp)
    assert _same(q, qr) and _same(s, sr)
    assert _same(d, kq.dequantize_int8_ref(q, s)[:n])
    qer, ser, rer = kq.quantize_ef_int8_ref(xp, efp)
    assert _same(qe, qer) and _same(se, ser) and _same(re, rer[:n])
    if special == "f32max":
        assert torch.isfinite(re[:768]).all()


def test_quant_kernels_take_views_at_any_offset(dev):
    """A view 4 bytes into its buffer is copied to a 16-byte boundary."""
    x, ef = _quant_input(2049, dev)
    q, s, _ = kq.quantize_int8(x[1:])
    qr, sr = kq.quantize_int8_ref(C.pad_to_block(x[1:].clone(), C.QTILE)[0])
    assert _same(q, qr) and _same(s, sr)
    _, _, r, _ = kq.quantize_ef_int8(x[1:], ef[1:])
    _, _, rr = kq.quantize_ef_int8_ref(
        C.pad_to_block(x[1:].clone(), C.QTILE)[0],
        C.pad_to_block(ef[1:].clone(), C.QTILE)[0])
    assert _same(r, rr[:2048])


def test_cuda_tensor_never_takes_the_plain_path(dev):
    x = torch.zeros(512, device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        C.compressed_psum(x, None, use_kernel=False)
    with pytest.raises(ValueError, match="float32"):
        kq.quantize_int8(x.half())
    with pytest.raises(ValueError, match="devices"):
        kq.quantize_ef_int8(x, x.cpu())
    before = kq.quantize_ef_int8.launches
    _, _, new, _ = kq.quantize_ef_int8(x + 1.0, x)   # the kernel, on the card
    assert new.is_cuda and kq.quantize_ef_int8.launches == before + 1


@pytest.mark.parametrize("n", [333, C.QTILE, 3 * C.QTILE - 100,
                               1_000_003])
def test_apply_error_feedback_takes_the_fused_kernel(dev, n):
    """On the card ``apply_error_feedback`` launches the fused quantise +
    EF kernel once and equals the plain path on the CPU bit for bit."""
    x, ef = _quant_input(n, dev)
    before = kq.quantize_ef_int8.launches
    g, new = C.apply_error_feedback(x, ef)
    torch.cuda.synchronize()
    assert kq.quantize_ef_int8.launches == before + 1
    g_cpu, new_cpu = C.apply_error_feedback(x.cpu(), ef.cpu(),
                                            use_kernel=False)
    assert _same(g.cpu(), g_cpu) and _same(new.cpu(), new_cpu)
    with pytest.raises(ValueError, match="CUDA tensor"):
        C.apply_error_feedback(x, ef, use_kernel=False)


def test_elastic_grid_on_card(dev, tmp_path):
    """4x1x1 ``multilevel_compress`` ranks sharing the card over gloo,
    pod 1 failing before step 1: an in-place repair, the checkpoint of
    step 2 written from 3 pods, and every survivor launching the fused EF
    and dequant kernels once per stacked leaf a step."""
    out = train("gpt-100m", steps=3, mesh_spec="4x1x1", seq=64, batch=4,
                comm="multilevel_compress", ckpt_dir=str(tmp_path),
                ckpt_every=2, fail_at={1: [1]}, smoke=True, device="cuda")
    assert (out["repairs"], out["recoveries"], out["world"]) == (1, 0, 3)
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert [(s["step"], s["pods"]) for s in out["saves"]] == [(2, 3)]
    assert len(out["launches"]) == 3
    for rank in out["launches"]:
        assert rank == out["launches"][0]
        assert rank["quantize_ef_int8"] == rank["dequantize_int8"] == 30


def test_elastic_model_axis_on_card(dev, tmp_path):
    """2x1x2 ``multilevel_compress`` ranks sharing the card over gloo,
    pod 1 failing before step 2: below quorum, a restart from step 1's
    checkpoint onto 1x1x2 with accum 2, its state restored bit for bit,
    and each survivor launching the fused EF and dequant kernels once per
    stacked leaf in the two steps that had two pods, and no more."""
    cfg = get_config("gpt_100m", smoke=True)
    out = train("gpt-100m", steps=3, mesh_spec="2x1x2", seq=64, batch=4,
                comm="multilevel_compress", ckpt_dir=str(tmp_path),
                ckpt_every=1, fail_at={2: [1]}, smoke=True, device="cuda",
                digests=True)
    assert (out["recoveries"], out["repairs"], out["accum"]) == (1, 0, 2)
    assert (out["world"], out["model"]) == (1, 2)
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert [(s["step"], s["pods"]) for s in out["saves"]] == [(1, 2), (2, 1)]
    assert out["restored"] == [{"step": 1,
                                "digest": out["saves"][0]["digest"]}]
    micro = 2 + 2                     # steps 0-1, then step 2 with accum 2
    assert len(out["launches"]) == 2
    for rank in out["launches"]:
        assert rank["quantize_ef_int8"] == rank["dequantize_int8"] == 2 * 10
        assert rank["flash_fwd"] == 2 * cfg.n_layers * micro
        assert rank["flash_bwd_dq"] == rank["flash_bwd_dkv"] \
            == cfg.n_layers * micro


def test_train_on_a_model_axis_on_card(dev):
    """``train --mesh 2x1x2 --comm multilevel_compress`` on the card: four
    gloo ranks share it, each with its model shard, the model axis's
    collectives staged through host memory; with f32 weights the losses
    within 1e-4 (relative, chip_smoke's phase 25c) of the same grid's on
    the CPU, the same model-axis collectives on each step, and every rank
    launching the flash kernels on its heads and the fused EF and dequant
    kernels once per stacked leaf a step."""
    from repro_torch.models.convert import stack_runs, to_numpy

    cfg = get_config("gpt_100m", smoke=True)
    params = to_numpy(stack_runs(_f32(T.init_model(cfg, seed=0,
                                                   device="cpu"), "cpu"),
                                 cfg))
    kw = dict(steps=3, mesh_spec="2x1x2", seq=64, batch=4,
              comm="multilevel_compress", smoke=True, init_params=params)
    out = train("gpt-100m", device="cuda", **kw)
    cpu = train("gpt-100m", device="cpu", **kw)
    assert out["model"] == 2 and out["staging"] == "host"
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    np.testing.assert_allclose(out["losses"], cpu["losses"], rtol=1e-4)
    assert all(c == out["tp_calls"][0] for c in out["tp_calls"])
    assert all(b > 0 for b in out["staged_bytes"])
    n = cfg.n_layers * 3
    assert len(out["launches"]) == 4
    for rank in out["launches"]:
        assert rank["flash_fwd"] == 2 * n
        assert rank["flash_bwd_dq"] == rank["flash_bwd_dkv"] == n
        assert rank["quantize_ef_int8"] == rank["dequantize_int8"] == 30


def _wkv_inputs(B, S, H, hd, decays, dev, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v, n = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
                  for _ in range(4))
    w = {"test": lambda: 1 / (1 + np.exp(-n)) * 0.6 + 0.39,
         "model": lambda: np.exp(-np.exp(np.clip(n, -8, 0.5))),
         "clip": lambda: np.full_like(n, np.exp(-np.exp(0.5))),
         "one": lambda: np.full_like(n, np.exp(-np.exp(-8.0)))}[decays]()
    u = 0.5 * rng.standard_normal((H, hd)).astype(np.float32)
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (r, k, v, w, u)]


def _pad_wkv(ins, S):
    r, k, v, w, u = ins
    pad = (0, 0, 0, 0, 0, S - r.shape[1])
    F = torch.nn.functional
    return [F.pad(t, pad) for t in (r, k, v)] + [F.pad(w, pad, value=1.0), u]


@pytest.mark.parametrize("B,S,H,hd,decays", [
    (8, 512, 32, 64, "model"),     # rwkv6-1.6b prefill
    (1, 304, 32, 64, "model"),     # batch 1: the heads split over blocks
    (2, 64, 2, 16, "test"), (1, 128, 4, 32, "test"), (1, 64, 1, 64, "test"),
    (1, 256, 32, 64, "clip"), (1, 256, 32, 64, "one"),
    (2, 48, 3, 24, "model"),       # a head dim that is no power of two
])
def test_wkv_kernel_matches_plain(dev, B, S, H, hd, decays):
    ins = _wkv_inputs(B, S, H, hd, decays, dev)
    before = kw.wkv_chunked.launches
    o, st = kw.wkv_chunked(*ins, return_state=True)
    o_only = kw.wkv_chunked(*ins)
    torch.cuda.synchronize()
    assert kw.wkv_chunked.launches == before + 2
    o_ref, st_ref = kw.wkv_chunk_scan_ref(*ins, kw.CHUNK)
    for got, want in ((o, o_ref), (st, st_ref)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.isfinite(got).all()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, atol=tol, rtol=0)
    assert torch.equal(o_only, o)


@pytest.mark.parametrize("B,S,H,hd,decays", [
    (1, 304, 32, 64, "model"), (2, 48, 3, 24, "model"),
    (1, 256, 32, 64, "clip")])
def test_wkv_kernel_split_is_exact(dev, B, S, H, hd, decays):
    """Column e of o and of the state needs only column e of v and of the
    state, and the kernel does a column's arithmetic the same way whichever
    block holds it: 1, 2, 4 and 5 blocks a head (5 divides neither 64 nor
    24: tiles of 13 or 5 columns, the last one short) give the same o and
    final state bit for bit."""
    ins = _wkv_inputs(B, S, H, hd, decays, dev)
    o1, s1 = kw.wkv_chunked(*ins, return_state=True, n_split=1)
    for n in (2, 4, 5):
        plan = kw.launch_plan(B, H, hd, n)
        assert plan["n_split"] == n and plan["blocks"] == B * H * n
        o, st = kw.wkv_chunked(*ins, return_state=True, n_split=n)
        torch.cuda.synchronize()
        assert torch.equal(o, o1) and torch.equal(st, s1), n


def test_wkv_launcher_splits_only_where_sms_idle(dev):
    """The launcher's choice: one block per (b, h) where the heads fill the
    SMs, else as many blocks a head as the SMs hold heads, at most
    ceil(hd / 16); all of the prefill shape's blocks resident at once."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, H, hd in ((8, 32, 64), (1, 32, 64), (1, 2, 64), (2, 3, 24),
                     (1, 200, 64)):
        want = min((hd + 15) // 16, max(1, sms // (B * H)))
        plan = kw.launch_plan(B, H, hd)
        assert plan["n_split"] == want and plan["blocks"] == B * H * want
        assert plan["threads"] == (4 * hd + 31) // 32 * 32
        assert (plan["chunk_width"], plan["head_width"]) == (16, 64)
        assert plan["exact"] == (hd == 64)
    assert kw.launch_plan(8, 32, 64)["blocks_per_sm"] * sms >= 8 * 32
    # above hd 64 a column is held by W / 16 lanes of 16 rows, and a block
    # by at most 512 threads (256 above chunk 16), so a head takes at
    # least hd / 64 (width 128; hd / 32 above chunk 16) or hd / 32 (width
    # 256) blocks
    for B, H, hd, chunk in ((8, 16, 128, 16), (8, 8, 256, 16),
                            (1, 1, 256, 16), (1, 4, 100, 24),
                            (200, 2, 72, 32)):
        lanes = kw.kernel_width(hd) // 16
        cb = (512 if chunk <= 16 else 256) // lanes
        floor = -(-hd // cb)
        want = max(floor, min((hd + 15) // 16, max(1, sms // (B * H))))
        plan = kw.launch_plan(B, H, hd, chunk=chunk)
        assert plan["n_split"] == want and plan["blocks"] == B * H * want
        assert plan["threads"] == lanes * cb and plan["blocks_per_sm"] >= 1
        assert plan["head_width"] == kw.kernel_width(hd)
        assert plan["chunk_width"] == (16 if chunk <= 16 else 32)
        assert plan["exact"] == (hd in (128, 256) and chunk in (16, 32))


def test_wkv_kernel_pad_leaves_state_exact(dev):
    """A 300-token request padded to 304 and to 320 (w = 1, zero r, k, v):
    the same final state and first 300 outputs, bit for bit."""
    ins = _wkv_inputs(1, 300, 32, 64, "model", dev)
    (o1, s1), (o2, s2) = (kw.wkv_chunked(*_pad_wkv(ins, S), return_state=True)
                          for S in (304, 320))
    assert torch.equal(s1, s2) and torch.equal(o1[:, :300], o2[:, :300])


def test_wkv_kernel_refuses_what_it_cannot_take(dev):
    """On the card the wrapper raises where ``kw.kernel_takes`` says no
    (hd above 256, chunk x head width above 4096), naming the limits."""
    ins = _wkv_inputs(1, 64, 2, 16, "test", dev)
    with pytest.raises(ValueError, match="one cpu or cuda device"):
        kw.wkv_chunked(ins[0].cpu(), *ins[1:])
    for hd, chunk in ((257, 16), (256, 17), (128, 33), (64, 65)):
        big = [torch.zeros(1, 2 * chunk, 1, hd, device=dev)
               for _ in range(4)]
        with pytest.raises(ValueError, match="head_dim 1..256 and chunk "
                           "1..64 with chunk x head width <= 4096"):
            kw.wkv_chunked(*big, torch.zeros(1, hd, device=dev),
                           chunk=chunk)


# (B, S, H, hd, chunk, decays): tests/test_torch_wkv.py's WIDE_CASES and
# rwkv6-1.6b's widths at hd 128 and 256, and padded instances (hd 100 in
# chunks of 24, hd 72 in chunks of 12, hd 200, hd 33 in chunks of 40)
WKV_WIDE = [(1, 32, 2, 80, 16, "model"), (1, 48, 1, 96, 16, "test"),
            (1, 32, 2, 128, 16, "clip"), (1, 32, 1, 256, 16, "model"),
            (1, 32, 2, 64, 1, "clip"), (2, 32, 1, 64, 4, "test"),
            (1, 64, 2, 64, 8, "clip"), (1, 48, 2, 64, 12, "model"),
            (1, 96, 1, 64, 32, "test"), (1, 128, 1, 64, 32, "model"),
            (1, 128, 1, 64, 64, "model"), (1, 128, 1, 64, 64, "test"),
            (8, 512, 16, 128, 16, "model"), (8, 512, 8, 256, 16, "model"),
            (2, 240, 3, 100, 24, "test"), (1, 96, 5, 72, 12, "model"),
            (1, 64, 2, 200, 16, "clip"), (2, 80, 2, 33, 40, "test")]


def _wkv_pad_chunks(ins, chunk, C):
    """A pad step (zero r, k, v; w = 1) after each chunk's last, to C."""
    r, k, v, w, u = ins
    B, S, H, hd = r.shape
    out = []
    for t, fill in ((r, 0.0), (k, 0.0), (v, 0.0), (w, 1.0)):
        x = torch.full((B, S // chunk, C, H, hd), fill, device=t.device)
        x[:, :, :chunk] = t.reshape(B, S // chunk, chunk, H, hd)
        out.append(x.reshape(B, -1, H, hd))
    return out + [u]


def _wkv_pad_head(ins, W):
    """Zero columns past hd to W (w = 1 there)."""
    F = torch.nn.functional
    r, k, v, w, u = ins
    pad = (0, W - r.shape[-1])
    return [F.pad(t, pad) for t in (r, k, v)] + [F.pad(w, pad, value=1.0),
                                                 F.pad(u, pad)]


@pytest.mark.parametrize("B,S,H,hd,chunk,decays", WKV_WIDE)
def test_wkv_kernel_wide_matches_plain(dev, B, S, H, hd, chunk, decays):
    """Every instance beside (16, 64) against the plain version; any
    n_split gives the same bits (1, 2, twice the head's floor and the
    launcher's choice; 1 and 2 are raised to the floor above hd 64, 32
    columns a block at hd 256); a padded chunk or head equals the
    exact instance on the inputs padded by the caller, bit for bit."""
    ins = _wkv_inputs(B, S, H, hd, decays, dev, seed=7)
    before = kw.wkv_chunked.launches
    o, st = kw.wkv_chunked(*ins, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert kw.wkv_chunked.launches == before + 1
    o_ref, st_ref = kw.wkv_chunk_scan_ref(*ins, chunk)
    for got, want in ((o, o_ref), (st, st_ref)):
        assert torch.isfinite(got).all()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, atol=tol, rtol=0)
    floor = kw.launch_plan(B, H, hd, 1, chunk=chunk)["n_split"]
    for n in (1, 2, min(hd, 2 * floor)):
        o_n, st_n = kw.wkv_chunked(*ins, chunk=chunk, return_state=True,
                                   n_split=n)
        assert torch.equal(o_n, o) and torch.equal(st_n, st), n
    plan = kw.launch_plan(B, H, hd, chunk=chunk)
    C, W = plan["chunk_width"], plan["head_width"]
    if chunk != C:
        po, ps = kw.wkv_chunked(*_wkv_pad_chunks(ins, chunk, C), chunk=C,
                                return_state=True)
        po = po.reshape(B, S // chunk, C, H, hd)[:, :, :chunk]
        assert torch.equal(po.reshape(B, S, H, hd), o)
        assert torch.equal(ps, st)
    if hd != W:
        po, ps = kw.wkv_chunked(*_wkv_pad_head(ins, W), chunk=chunk,
                                return_state=True)
        assert torch.equal(po[..., :hd], o)
        assert torch.equal(ps[..., :hd, :hd], st)


def test_wkv_function_at_chunk_8_launches_the_kernel(dev):
    """``wkv`` at chunk 8 through autograd: one launch in chunks of 8 (o
    within 1e-4 of the plain version), and its backward autograd through
    the plain scan at chunk 8, equal to that graph's own bit for bit."""
    ins = _wkv_inputs(2, 64, 3, 64, "test", dev, seed=8)
    cots = [torch.randn(s, device=dev, generator=torch.Generator(
        device=dev).manual_seed(9)) for s in ((2, 64, 3, 64), (2, 3, 64, 64))]
    a = [t.clone().requires_grad_(True) for t in ins]
    b = [t.clone().requires_grad_(True) for t in ins]
    before = kw.wkv_chunked.launches
    o, st = kw.wkv(*a, chunk=8, return_state=True)
    torch.cuda.synchronize()
    assert kw.wkv_chunked.launches == before + 1
    want_o, want_st = kw.wkv_chunk_scan_ref(*b, 8)
    for got, want in ((o, want_o), (st, want_st)):
        tol = 1e-4 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got.detach(), want.detach(), atol=tol,
                                   rtol=0)
    got = torch.autograd.grad([o, st], a, cots)
    want = torch.autograd.grad([want_o, want_st], b, cots)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and torch.equal(g, w)


@pytest.mark.parametrize("B,S,H,hd,decays", [
    (2, 64, 2, 16, "test"), (1, 304, 32, 64, "model"),
    (1, 256, 32, 64, "clip")])
def test_wkv_function_launches_the_kernel_and_its_gradient_is_plain(
        dev, B, S, H, hd, decays):
    """With a gradient to take, ``wkv`` launches the kernel once in its
    forward (o within the kernel's 1e-4 of the plain version), and its
    backward is autograd through the plain scan on the card: the five
    gradients equal those of the plain scan's own graph, bit for bit."""
    ins = _wkv_inputs(B, S, H, hd, decays, dev, seed=5)
    rng = np.random.default_rng(6)
    cots = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dev) for s in ((B, S, H, hd), (B, H, hd, hd))]
    a = [t.clone().requires_grad_(True) for t in ins]
    b = [t.clone().requires_grad_(True) for t in ins]
    before = kw.wkv_chunked.launches
    o, st = kw.wkv(*a, return_state=True)
    torch.cuda.synchronize()
    assert kw.wkv_chunked.launches == before + 1
    assert "WKV" in type(o.grad_fn).__name__
    want_o, want_st = kw.wkv_chunk_scan_ref(*b, kw.CHUNK)
    for got, want in ((o, want_o), (st, want_st)):
        tol = 1e-4 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got.detach(), want.detach(), atol=tol,
                                   rtol=0)
    got = torch.autograd.grad([o, st], a, cots)
    want = torch.autograd.grad([want_o, want_st], b, cots)
    assert kw.wkv_chunked.launches == before + 1     # no kernel backward
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and torch.equal(g, w)


def test_rwkv6_training_on_card_matches_cpu(dev):
    """rwkv6-1.6b smoke in f32: the loss and every gradient leaf on the
    card against the CPU within 1e-4 (loss relative, leaves of their
    largest entry); the card launches the WKV kernel twice a layer, in
    the forward and in the remat's re-run."""
    cfg = get_config("rwkv6_1p6b", smoke=True)
    params = _f32(T.init_model(cfg, seed=0, device="cpu"), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 100),
                         generator=torch.Generator().manual_seed(0))
    runs = {}
    for d in ("cpu", dev):
        before = kw.wkv_chunked.launches
        batch = device_batch({"tokens": toks.numpy(),
                              "labels": toks.numpy()}, d)
        runs[d] = loss_and_grads(_f32(params, d), cfg, batch)
        assert kw.wkv_chunked.launches - before == \
            (2 * cfg.n_layers if d != "cpu" else 0)
    (l_c, g_c), (l_g, g_g) = runs["cpu"], runs[dev]
    assert abs(l_g.item() - l_c.item()) <= 1e-4 * abs(l_c.item())
    for g, c in zip(tree_leaves(g_g), tree_leaves(g_c)):
        top = c.abs().max().item()
        torch.testing.assert_close(g.cpu(), c, atol=1e-4 * top, rtol=0)


def test_rwkv6_serving_on_card_matches_cpu(dev):
    """rwkv6-1.6b smoke in f32, prefill of a ragged 21-token prompt and 4
    steps fed the CPU's tokens: logits and every cache leaf on the card
    against the CPU; one WKV launch per layer and prefill."""
    cfg = get_config("rwkv6_1p6b", smoke=True)
    params = _f32(T.init_model(cfg, seed=0, device="cpu"), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 21),
                         generator=torch.Generator().manual_seed(0))
    runs, fed = {}, []
    for d in ("cpu", dev):
        p = _f32(params, d)
        before = kw.wkv_chunked.launches
        logits, cache, pos = make_prefill_fn(cfg, 32)(
            p, {"tokens": toks.to(d)})
        assert kw.wkv_chunked.launches - before == \
            (cfg.n_layers if d != "cpu" else 0)
        lgs = [logits.cpu()]
        for i in range(4):
            if d == "cpu":
                fed.append(logits[:, -1].argmax(-1, keepdim=True))
            logits, cache = make_decode_fn(cfg)(p, cache, fed[i].to(d),
                                                pos + i)
            lgs.append(logits.cpu())
        runs[d] = lgs, [{k: t.cpu() for k, t in e.items()} for e in cache]
    (lg_c, c_c), (lg_g, c_g) = runs["cpu"], runs[dev]
    for a, b in zip(lg_g, lg_c):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    for eg, ec in zip(c_g, c_c):
        top = ec["S"].abs().max().item()
        torch.testing.assert_close(eg["S"], ec["S"], atol=1e-4 * top, rtol=0)
        for name in ("x_tm", "x_cm"):
            torch.testing.assert_close(eg[name].float(), ec[name].float(),
                                       rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("arch", ["rwkv6_1p6b", "seamless_m4t_medium",
                                  "recurrentgemma_2b"])
def test_model_axis_prefill_of_the_families_on_card(dev, arch):
    """RWKV-6, enc-dec and the RG-LRU on a model axis on the card: two
    gloo ranks share it, each its shard of the smoke config in f32; the
    dense prefill's logits within 1e-5 of one rank's on the card
    (chip_smoke's phase 24d), every cache leaf of the rank joined over the
    axis within 1e-4 of its scale (the f32 WKV and RG-LRU states) or one
    bf16 ulp (bf16 leaves); each rank launches the WKV kernel once a
    layer on its heads, or the flash forward once an attention layer
    (recurrentgemma's local layer on 2 query heads and the one KV head),
    and for enc-dec once an encoder layer and a cross attention."""
    import _torch_ranks
    from repro_torch.launch.mesh import run_ranks

    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(0)
    # a windowed layer's dense prefill takes whole windows (8)
    L_ = 16 if "local" in cfg.pattern else 21
    ins = {"tokens": rng.integers(0, cfg.vocab, (2, L_))}
    if cfg.enc_dec is not None:
        ins["src_embeds"] = rng.standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)
    s_max = 32
    ranks = run_ranks(_torch_ranks.family_prefill_on_card, 2, "gloo",
                      (arch, ins, s_max), timeout=600.0)
    params = _f32(T.init_model(cfg, seed=0, device="cpu"), dev)
    inputs = {k: torch.from_numpy(v).to(dev) for k, v in ins.items()}
    lg, cache, _ = make_prefill_fn(cfg, s_max)(params, inputs)
    n_attn = sum(k in ("attn", "local") for k in cfg.pattern)
    flash = n_attn + (cfg.enc_dec.n_enc_layers + n_attn if cfg.enc_dec
                      else 0)
    for r in ranks:
        np.testing.assert_allclose(r["logits"], lg.cpu().numpy(), atol=1e-5,
                                   rtol=0)
        assert (r["wkv"], r["flash_fwd"]) == (
            sum(k == "rwkv6" for k in cfg.pattern), flash)
    for i, ent in enumerate(cache):
        for k, want in ent.items():
            want = want.float().cpu()
            parts = [torch.from_numpy(r["cache"][i][k]) for r in ranks]
            dims = [d for d in range(want.dim())
                    if parts[0].shape[d] != want.shape[d]]
            got = torch.cat(parts, dims[0]) if dims else parts[0]
            if ent[k].dtype == torch.float32:
                top = want.abs().max().item()
                torch.testing.assert_close(got, want, atol=1e-4 * top,
                                           rtol=0)
            else:
                torch.testing.assert_close(got, want, rtol=2.0 ** -7,
                                           atol=1e-6)


def test_head_cut_on_a_model_axis_of_4_on_card(dev):
    """recurrentgemma's smoke config with 10 heads on 1x1x4 on the card:
    four gloo ranks share it, each its f32 shard, its 40 query columns
    (2.5 heads of 16) gathered and the 3 heads they meet computed; the
    dense prefill's logits within 1e-5 of one rank's on the card, each
    decode step from the one-rank cache within 1e-4, the loss within
    1e-5 relative and each gradient leaf of the rank within 1e-4 of its
    largest; each rank launches the flash forward once in the prefill
    (the local layer) and twice in the training step, and each backward
    kernel once, on its 3 heads."""
    import dataclasses

    import _torch_ranks
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.convert import shard_params, stack_runs
    from repro_torch.models.sharding import rank_heads

    cfg = dataclasses.replace(get_config("recurrentgemma_2b", smoke=True),
                              n_heads=10)
    assert [rank_heads(cfg, 4, m).nq for m in range(4)] == [3] * 4
    rng = np.random.default_rng(3)
    ins = {"tokens": rng.integers(0, cfg.vocab, (2, 16)),
           "forced": rng.integers(0, cfg.vocab, (3, 2, 1))}
    s_max = 24
    batch = DataPipeline(cfg, ShapeSpec("test", "train", 64, 2)).host_batch(0)
    full = _f32(T.init_model(cfg, seed=0, device="cpu"), dev)
    lg, cache, S = T.prefill(full, cfg, {"tokens": torch.from_numpy(
        ins["tokens"]).to(dev)}, s_max)
    steps, before = [], []
    for i, t in enumerate(ins["forced"]):
        before.append([{k: v.float().cpu().numpy().copy()
                        for k, v in ent.items()}
                       for ent in cache])
        step, cache = T.decode_step(full, cfg, cache,
                                    torch.from_numpy(t).to(dev), S + i)
        steps.append(step.cpu().numpy())
    loss, grads = loss_and_grads(stack_runs(full, cfg), cfg,
                                 device_batch(batch, dev))
    ranks = run_ranks(_torch_ranks.headcut_on_card, 4, "gloo",
                      (cfg, ins, s_max, batch, before), timeout=600.0)
    for m, r in enumerate(ranks):
        np.testing.assert_allclose(r["prefill"], lg.cpu().numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(np.stack(r["steps"]), np.stack(steps),
                                   atol=1e-4, rtol=0)
        assert abs(r["loss"] - loss.item()) <= 1e-5 * abs(loss.item())
        want = tree_leaves(shard_params(grads, cfg, 4, m))
        got = tree_leaves(r["grads"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = w.cpu().numpy()
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
        assert r["launches"] == [3, 1, 1]


def test_wrappers_on_meta_give_the_cards_shapes(dev):
    """The dry run's ``meta`` tensors in a CUDA build: each wrapper gives
    the shapes and dtypes its kernel gives on the card, and launches
    nothing."""
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    meta = lambda ts: [t.to("meta") for t in ts]
    spec = lambda ts: [(tuple(t.shape), t.dtype) if isinstance(
        t, torch.Tensor) else t for t in tree_leaves(ts)]
    q = rnd(2, 96, 8, 64).bfloat16()
    k, v = rnd(2, 128, 2, 64).bfloat16(), rnd(2, 128, 2, 64).bfloat16()
    kwm = dict(causal=True, window=48, q_offset=32)
    o, lse = fa.flash_attention_fwd(q, k, v, **kwm)
    do = rnd(*q.shape).bfloat16()
    x, ef = rnd(5000), rnd(5000)
    q8, s, _ = kq.quantize_int8(x)
    r, kk, vv, u = rnd(1, 64, 4, 32), rnd(1, 64, 4, 32), rnd(1, 64, 4, 32), \
        rnd(4, 32)
    w = torch.rand((1, 64, 4, 32), generator=g, device=dev)
    calls = [
        (fa.flash_attention_fwd, (q, k, v), kwm),
        (fa.flash_attention_bwd, (q, k, v, o, lse, do), kwm),
        (kq.quantize_int8, (x,), {}),
        (kq.dequantize_int8, (q8, s), {}),
        (kq.quantize_ef_int8, (x, ef), {}),
        (kw.wkv_chunked, (r, kk, vv, w, u), {"return_state": True})]
    kernels = (fa.flash_attention_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
               kq.quantize_int8, kq.dequantize_int8, kq.quantize_ef_int8,
               kw.wkv_chunked)
    for fn, args, kw_ in calls:
        card = fn(*args, **kw_)
        before = [f.launches for f in kernels]
        dry = fn(*meta(args), **kw_)
        assert [f.launches for f in kernels] == before
        assert spec(dry) == spec(card)
        assert all(t.is_meta for t in tree_leaves(dry)
                   if isinstance(t, torch.Tensor))
