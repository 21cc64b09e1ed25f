"""The port's int8 quantiser, dequantiser and fused error feedback against
the JAX package on the CPU.

* The plain versions (``repro_torch.core.compression``) against the
  reference's eager jnp path (``repro.core.compression`` called outside
  ``jit``), bit for bit: q, scales, dequant and the EF residual, at lengths
  256, QTILE, 3 QTILE - 100 and 333, with ties at .5 and an all-zero block.
* The kernel wrappers (``repro_torch.kernels.quant``, plain versions on
  the CPU) against ``repro.kernels.ops`` in Pallas interpret mode, which
  is jitted: XLA divides by 127 as a product with the reciprocal, so the
  scales are held within 1 ulp, q within 1, the dequant bit for bit on the
  same q and scales, and the residual within one scale step.
* The edge cases: a NaN block, F32_MAX, and the port's copy of
  ``partition_buckets``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import engine as JENGINE
from repro.kernels import ops as JOPS
from repro_torch.core import compression as C
from repro_torch.core.engine import partition_buckets
from repro_torch.kernels import quant as kq

LENGTHS = [256, C.QTILE, 3 * C.QTILE - 100, 333]


def _x(n, seed=0):
    """Normal values with, where the length allows, a block of ties (scale
    exactly 1: amax 127 and values k + 0.5) and an all-zero block."""
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal(n)).astype(np.float32)
    if n >= 512:
        x[256:512] = (np.arange(256) % 20 - 9.5).astype(np.float32)
        x[256] = 127.0
    if n >= 768:
        x[512:768] = 0.0
    return x


def _ef(n, seed=1):
    return (0.05 * np.random.default_rng(seed).standard_normal(n)).astype(
        np.float32)


def _bits(a):
    return np.asarray(a).view(np.uint8)


def test_constants_match_reference():
    assert (C.BLOCK, C.TILE, C.QTILE, C.WIRE_BYTES_PER_ELEM) == (
        JC.BLOCK, JC.TILE, JC.QTILE, JC.WIRE_BYTES_PER_ELEM)


@pytest.mark.parametrize("n", LENGTHS)
def test_plain_quantise_bit_exact_with_eager_reference(n):
    x = _x(n)
    xp, pad = C.pad_to_block(torch.from_numpy(x))
    jxp, jpad = JC.pad_to_block(jnp.asarray(x))
    assert pad == jpad
    q, s = C.quantize_int8(xp)
    jq, js = JC.quantize_int8(jxp)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(_bits(s.numpy()), _bits(js))
    deq = C.dequantize_int8(q, s)
    assert np.array_equal(_bits(deq.numpy()),
                          _bits(JC.dequantize_int8(jq, js)))


@pytest.mark.parametrize("n", LENGTHS)
def test_plain_error_feedback_bit_exact_with_eager_reference(n):
    """The fused plain version on the padded buffer against the
    reference's eager ``apply_error_feedback``: the same residual, and the
    q and scales of x + ef."""
    x, ef = _x(n), _ef(n)
    _, jnew = JC.apply_error_feedback(jnp.asarray(x), jnp.asarray(ef),
                                      use_kernel=False)
    xp, _ = C.pad_to_block(torch.from_numpy(x))
    efp, _ = C.pad_to_block(torch.from_numpy(ef))
    q, s, r = C.quantize_ef_int8(xp, efp)
    jq, js = JC.quantize_int8(JC.pad_to_block(jnp.asarray(x + ef))[0])
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(_bits(s.numpy()), _bits(js))
    assert np.array_equal(_bits(r[:n].numpy()), _bits(jnew))


@pytest.mark.parametrize("n", LENGTHS)
def test_wrappers_match_pallas_interpret(n):
    x, ef = _x(n), _ef(n)
    q, s, pad = kq.quantize_int8(torch.from_numpy(x))
    jq, js, jpad = JOPS.quantize_int8(jnp.asarray(x), interpret=True)
    assert pad == jpad == (-n) % C.QTILE and q.numel() == n + pad
    s, js = s.numpy(), np.asarray(js)
    ulps = np.abs(s.view(np.int32).astype(np.int64)
                  - js.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert np.abs(q.numpy().astype(int)
                  - np.asarray(jq).astype(int)).max() <= 1
    # dequant of the same q and scales: one product, bit for bit
    jx = JOPS.dequantize_int8(jq, jnp.asarray(js), jpad, interpret=True)
    x2 = kq.dequantize_int8(torch.from_numpy(np.array(jq)),
                            torch.from_numpy(np.array(js)), pad)
    assert x2.numel() == n
    assert np.array_equal(_bits(x2.numpy()), _bits(jx))
    # fused EF: q within 1 means the residual within one scale step
    q, s, r, pad = kq.quantize_ef_int8(torch.from_numpy(x),
                                       torch.from_numpy(ef))
    jq, js, jr, jpad = JOPS.quantize_ef_int8(jnp.asarray(x), jnp.asarray(ef),
                                             interpret=True)
    assert pad == jpad and r.numel() == n
    step = np.repeat(s.numpy(), C.BLOCK)[:n]
    assert np.all(np.abs(r.numpy() - np.asarray(jr)) <= 1.0001 * step)


def test_nan_block_gets_nan_scale_and_zero_payload():
    x = _x(3 * 256)
    x[300] = np.nan
    q, s = C.quantize_int8(torch.from_numpy(x))
    jq, js = JC.quantize_int8(jnp.asarray(x))
    s, js = s.numpy(), np.asarray(js)
    assert np.isnan(s[1]) and np.isnan(js[1])
    assert np.array_equal(s[[0, 2]], js[[0, 2]])
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert q[300] == 0


def test_residual_at_f32_max_stays_finite():
    """127 * (F32_MAX / 127) rounds to inf: the residual clamps the product
    to +-F32_MAX (the Pallas kernel clamps the positive side), where the
    reference's eager path leaves -inf."""
    x = np.zeros(2 * 256, np.float32)
    x[0], x[256] = C.F32_MAX, -C.F32_MAX
    _, _, r = C.quantize_ef_int8(torch.from_numpy(x), torch.zeros(512))
    assert torch.isfinite(r).all() and r[0] == 0 and r[256] == 0
    _, jr = JC.apply_error_feedback(jnp.asarray(x), jnp.zeros(512),
                                    use_kernel=False)
    assert np.isneginf(np.asarray(jr)[0])
    assert np.array_equal(r[1:256].numpy(), np.asarray(jr)[1:256])


def test_inputs_are_checked():
    with pytest.raises(ValueError, match="multiple of the block"):
        C.quantize_int8(torch.zeros(300))
    with pytest.raises(ValueError, match="block=256"):
        C.compressed_psum(torch.zeros(512), None, block=128, use_kernel=True)
    with pytest.raises(ValueError, match="matching"):
        kq.quantize_ef_int8(torch.zeros(10), torch.zeros(11))
    with pytest.raises(ValueError, match="int8"):
        kq.dequantize_int8(torch.zeros(256), torch.zeros(1))
    with pytest.raises(ValueError, match="one scale per block"):
        kq.dequantize_int8(torch.zeros(256, dtype=torch.int8), torch.zeros(2))
    assert kq.quantize_int8.launches == kq.dequantize_int8.launches == \
        kq.quantize_ef_int8.launches == 0          # the CPU never launches


@pytest.mark.parametrize("bucket_bytes,reverse", [(1.0, True), (500.0, True),
                                                  (500.0, False), (1e9, True)])
def test_partition_buckets_matches_reference(bucket_bytes, reverse):
    sizes = list(np.random.default_rng(3).integers(1, 300, 17) * 4.0)
    assert partition_buckets(sizes, bucket_bytes, reverse) == \
        JENGINE.partition_buckets(sizes, bucket_bytes, reverse)

