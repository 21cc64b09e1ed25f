"""Closed-form postal cost models and the card's roofline.

The paper's §4 napkin math — binomial vs multilevel bcast cost over C
clusters of P processes — used to validate the simulator against the
paper's own claim (log C -> 1 slow messages), the pipelining segment
sizes, and the affine link fit: a copy of the postal half of
``repro/core/costmodel.py``.

The roofline half (``HW``, ``roofline_terms``, ``kernel_roofline``,
``refit_hw``) has the reference's numerics, read against the ceilings of
an NVIDIA H100 SXM5 80GB HBM3 at 700 W from its datasheet (``H100``;
``H100_F32`` for the kernels that run f32 on the CUDA cores) instead of a
TPU's.  The two link rates are named for the levels they serve:
``fast_bw`` inside a pod (NVLink), ``slow_bw`` across pods (the card's
network port), where the reference has ``ici_bw`` and ``dcn_bw``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "binomial_bcast_cost",
    "multilevel_bcast_cost",
    "two_level_bcast_cost",
    "bdp_segment_bytes",
    "pipeline_segment_bytes",
    "MAX_SEGMENTS",
    "MIN_CHUNK_BYTES",
    "link_affine_fit",
    "HW",
    "H100",
    "H100_F32",
    "roofline_terms",
    "kernel_roofline",
    "refit_hw",
]


# ---------------------------------------------------------------------- #
# Paper §4 closed forms.  Params: slow link (l_s, b_s), fast link (l_f, b_f).
# ---------------------------------------------------------------------- #

def binomial_bcast_cost(P: int, C: int, nbytes: float,
                        l_s: float, b_s: float, l_f: float, b_f: float) -> float:
    """Topology-unaware binomial tree: >= log2(C) inter-cluster messages on
    the longest path plus log2(P/C) intra-cluster messages."""
    inter = math.log2(max(C, 1)) if C > 1 else 0.0
    intra = math.log2(max(P // max(C, 1), 1))
    return inter * (l_s + nbytes / b_s) + intra * (l_f + nbytes / b_f)


def multilevel_bcast_cost(P: int, C: int, nbytes: float,
                          l_s: float, b_s: float, l_f: float, b_f: float) -> float:
    """Paper's multilevel method: exactly 1 message on the slow link (flat
    inter-cluster stage overlaps across clusters), then log2(P/C) fast ones."""
    inter = 1.0 if C > 1 else 0.0
    intra = math.log2(max(P // max(C, 1), 1))
    return inter * (l_s + nbytes / b_s) + intra * (l_f + nbytes / b_f)


def two_level_bcast_cost(P: int, C: int, nbytes: float,
                         l_s: float, b_s: float, l_f: float, b_f: float) -> float:
    """MagPIe-style 2-level machine clustering: the root sends one message to
    EVERY other cluster across the slow network (C-1 sequential injections on
    one NIC), then binomial within clusters."""
    inter = (C - 1) * (l_s + nbytes / b_s) if C > 1 else 0.0
    intra = math.log2(max(P // max(C, 1), 1)) * (l_f + nbytes / b_f)
    return inter + intra


# ---------------------------------------------------------------------- #
# Pipelining: segment sizes from the bandwidth-delay product.
# ---------------------------------------------------------------------- #

# Bound on segments per transfer: keeps the lowered-plan size (and the cost
# of simulating one candidate in the "auto" argmin) linear in tree size
# rather than in message bytes.
MAX_SEGMENTS = 64

# Floor on the chunk size of scatter-based algorithms: chunks below this
# cannot amortise per-message latency/overhead, so small payloads fall back
# to fewer (down to one) chunks and the latency-optimal tree plan wins the
# argmin — the standard large/small-message switch.
MIN_CHUNK_BYTES = 8192.0


def bdp_segment_bytes(level) -> float:
    """Bandwidth-delay product of one link class: the bytes in flight when a
    sender streams continuously.  Segments smaller than this waste the link
    on per-message latency; much larger ones forfeit overlap between the
    levels of a multilevel tree."""
    return level.bandwidth * (level.latency + level.overhead)


def pipeline_segment_bytes(levels, nbytes: float,
                           max_segments: int = MAX_SEGMENTS) -> float:
    """Segment size for pipelining ``nbytes`` over a path using ``levels``.

    Per link class the natural segment is its bandwidth-delay product; a
    multilevel path is governed by the largest of them (the slowest stratum:
    segments below its BDP pay WAN latency per piece without increasing
    overlap).  Rounded to a power of two, clamped to [1 KiB, nbytes], and
    floored so no transfer shatters into more than ``max_segments`` pieces.
    """
    if nbytes <= 0:
        return nbytes
    bdp = max(bdp_segment_bytes(l) for l in levels)
    seg = 2.0 ** round(math.log2(max(bdp, 1024.0)))
    floor = nbytes / max_segments
    if seg < floor:
        # Round the floor back UP to a power of two: the raw quotient is
        # almost never one, and a non-power-of-two segment would violate
        # the documented invariant (and mis-bucket downstream plan keys).
        seg = 2.0 ** math.ceil(math.log2(floor))
    return min(seg, nbytes)


def link_affine_fit(samples, *, fallback_latency: float = 0.0,
                    ) -> tuple[float, float]:
    """Fit postal parameters (latency, bandwidth) to observed transfers.

    ``samples`` are ``(nbytes, seconds, first)`` rows as harvested from
    traced link intervals (:meth:`repro_torch.obs.Tracer.link_samples`): a
    *first* send's delivery takes ``latency + nbytes/bandwidth``, a
    pipelined follower just ``nbytes/bandwidth`` — so the design matrix is
    ``[first, nbytes]`` and least squares separates the intercept from the
    slope whenever the sample set mixes firsts with followers or spans
    more than one size.  When it does not (rank-deficient: one size, all
    firsts), latency is pinned to ``fallback_latency`` — the caller's
    current model value — and only bandwidth is solved; a feedback refit
    must never *invent* a latency the data cannot identify.

    Returns ``(latency_s, bandwidth_bytes_per_s)``, both clamped positive.
    """
    a = np.asarray([(n, t, 1.0 if f else 0.0) for n, t, f in samples],
                   dtype=float)
    if a.size == 0:
        raise ValueError("link_affine_fit needs at least one sample")
    n, t, f = a[:, 0], a[:, 1], a[:, 2]
    X = np.stack([f, n], axis=1)
    if np.linalg.matrix_rank(X) == 2:
        (lat, slope), *_ = np.linalg.lstsq(X, t, rcond=None)
        lat = max(float(lat), 0.0)
    else:
        lat = max(float(fallback_latency), 0.0)
        pos = n > 0
        if not pos.any():
            raise ValueError("cannot fit bandwidth from zero-byte samples")
        slope = float(np.mean((t[pos] - f[pos] * lat) / n[pos]))
    slope = max(float(slope), 1e-30)
    return lat, 1.0 / slope



# ---------------------------------------------------------------------- #
# The card's roofline
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float        # FLOP/s per card (dense)
    hbm_bw: float            # bytes/s per card
    fast_bw: float           # bytes/s per card each way, inside a pod
    slow_bw: float           # bytes/s per card, across pods
    hbm_bytes: float         # HBM capacity per card
    smem_bytes: float        # shared memory per SM


# NVIDIA H100 SXM5 80GB HBM3, 700 W (datasheet): dense bf16 on the tensor
# cores, HBM3, NVLink 4 (900 GB/s both ways), one 400 Gb/s NDR port a card
H100 = HW(
    name="h100",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    fast_bw=450e9,
    slow_bw=50e9,
    hbm_bytes=80e9,
    smem_bytes=228 * 2**10,
)

# the same card for the f32 kernels, on the CUDA cores (67 TFLOP/s)
H100_F32 = dataclasses.replace(H100, name="h100_f32", peak_flops=67e12)


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    fast_bytes: float,
    chips: int,
    hw: HW = H100,
    slow_bytes: float = 0.0,
) -> dict[str, float]:
    """The three roofline terms, in seconds, for one step on ``chips``
    cards.

    ``flops`` / ``hbm_bytes`` are GLOBAL totals (over the ``chips``);
    ``fast_bytes`` is the per-card collective traffic inside a pod,
    ``slow_bytes`` the per-card traffic crossing the pod boundary.
    """
    compute = flops / (chips * hw.peak_flops)
    memory = hbm_bytes / (chips * hw.hbm_bw)
    collective = fast_bytes / hw.fast_bw + slow_bytes / hw.slow_bw
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    terms["bound"] = max(terms, key=terms.get).replace("_s", "")
    terms["step_s"] = max(compute, memory, collective)
    return terms


def kernel_roofline(
    flops: float,
    hbm_bytes: float,
    hw: HW = H100,
    wall_s: float | None = None,
) -> dict[str, float]:
    """One card's roofline for ONE kernel: its FLOPs and HBM bytes against
    the card's two ceilings (no collective term — kernels are local).

    Returns compute_s / memory_s, the kernel's arithmetic intensity vs the
    card's ridge point (FLOP/byte where the two ceilings meet), which
    ceiling binds, and the model wall ``model_s = max(...)``.  With a
    measured ``wall_s``, adds the achieved-vs-peak fractions
    (``achieved_flops_frac`` / ``achieved_bw_frac``) and the model/measured
    ratio, which :func:`refit_hw` consumes to derate the HW constants to a
    machine.
    """
    if flops < 0 or hbm_bytes <= 0:
        raise ValueError(f"kernel_roofline needs flops >= 0 and "
                         f"hbm_bytes > 0, got {flops=} {hbm_bytes=}")
    compute = flops / hw.peak_flops
    memory = hbm_bytes / hw.hbm_bw
    out = {
        "compute_s": compute,
        "memory_s": memory,
        "intensity": flops / hbm_bytes,
        "ridge": hw.peak_flops / hw.hbm_bw,
        "bound": "compute" if compute >= memory else "memory",
        "model_s": max(compute, memory),
    }
    if wall_s is not None:
        if wall_s <= 0:
            raise ValueError(f"wall_s must be positive, got {wall_s}")
        out["wall_s"] = wall_s
        out["achieved_flops_frac"] = (flops / wall_s) / hw.peak_flops
        out["achieved_bw_frac"] = (hbm_bytes / wall_s) / hw.hbm_bw
        out["model_over_wall"] = out["model_s"] / wall_s
    return out


def refit_hw(hw: HW, *, flops_frac: float, bw_frac: float, name: str) -> HW:
    """Derate a datasheet :class:`HW` to MEASURED ceilings: scale
    ``peak_flops`` / ``hbm_bw`` by the best achieved fractions the kernels
    showed, so that later :func:`roofline_terms` / :func:`kernel_roofline`
    calls model this machine instead of the datasheet.  Fractions are
    clamped to (0, 1] — a kernel cannot beat the roof; measuring above it
    means the byte/FLOP model is wrong, not the silicon generous."""
    f = min(max(flops_frac, 1e-6), 1.0)
    b = min(max(bw_frac, 1e-6), 1.0)
    return dataclasses.replace(
        hw, name=name, peak_flops=hw.peak_flops * f, hbm_bw=hw.hbm_bw * b)
