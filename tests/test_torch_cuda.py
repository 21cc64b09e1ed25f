"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper card and skip elsewhere; on the machine
with the card run them with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  This file imports no JAX: the card's machine
has none.  The plain versions are checked against JAX on the CPU in
``tests/test_torch_flash.py``.

Tolerances: 3e-5 (f32) and 2e-2 (bf16) absolute, the JAX kernel tests'
own; the kernel sums in another order than the plain version, and bf16
outputs may round to the neighbouring value.  TF32 is off for the plain
version's f32 einsums.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as T
from repro_torch.serving import ReqState

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


def test_flash_kernel_rejects_what_it_cannot_take(dev):
    q, k, v = _inputs(1, 64, 64, 4, 2, 48, torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = _inputs(1, 64, 64, 4, 2, 64, torch.float16, dev)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_fwd(q, k, v)


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


def test_serve_on_card_launches_the_kernel(dev):
    cfg = get_config("qwen3_4b", smoke=True)
    fa.flash_attention_fwd.launches = 0
    out = serve("qwen3-4b", 3, 21, 5, smoke=True, device="cuda")
    assert all(r.state is ReqState.DONE for r in out["requests"])
    assert out["generated"].shape == (3, 5)
    assert fa.flash_attention_fwd.launches == cfg.n_layers * out["prefills"]
