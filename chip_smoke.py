#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. the card: its name and power limit (nvidia-smi), torch and CUDA versions;
2. the build of every kernel under src/repro_torch/kernels/csrc (one nvcc
   per source, all started together), timed as set-up;
3. every kernel against its plain PyTorch version on the card, at the
   shapes of the models the port serves, with its time beside the plain
   version's, the library call's (timed only, never used by the port) and
   its roofline bound; one JSON line per shape;
4. the main path: ``repro_torch.launch.serve.serve`` on gpt-100m at full
   width (12 layers, d 768, random weights from a seed), 8 requests of 512
   prompt tokens and one ragged 300-token request, 16 new tokens each,
   with every launch counter set to 0 just before and read just after;
5. the answer: the same weights in f32 on the card and on the CPU give the
   same prefill logits for a ragged prompt.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  TF32 is off throughout.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = ROOT / "src" / "repro_torch" / "kernels"

# (tolerance on o and lse, the kernel tests' own: f32 3e-5, bf16 2e-2)
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
# Peak rates of one H100 SXM (NVIDIA data sheet, dense): bf16 on the tensor
# cores, f32 on the CUDA cores; HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# (name, B, Sq, Sk, H, Hkv, hd, causal, window, q_offset, dtype)
SHAPES = [
    ("gpt-100m prefill", 1, 512, 512, 12, 12, 64, True, None, 0, "bfloat16"),
    ("gpt-100m prefill", 1, 512, 512, 12, 12, 64, True, None, 0, "float32"),
    ("gpt-100m", 4, 512, 512, 12, 12, 64, True, None, 0, "bfloat16"),
    ("gpt-100m", 1, 2048, 2048, 12, 12, 64, True, None, 0, "bfloat16"),
    ("gpt-100m", 4, 2048, 2048, 12, 12, 64, True, None, 0, "bfloat16"),
    ("tinyllama-1.1b", 1, 2048, 2048, 32, 4, 64, True, None, 0, "bfloat16"),
    ("qwen3-4b", 1, 2048, 2048, 32, 8, 128, True, None, 0, "bfloat16"),
    ("qwen3-4b", 1, 2048, 2048, 32, 8, 128, True, None, 0, "float32"),
    ("ragged", 2, 777, 777, 12, 12, 64, True, None, 0, "bfloat16"),
    ("ragged", 2, 777, 777, 32, 8, 128, True, None, 0, "float32"),
    ("window", 1, 2048, 2048, 32, 8, 128, True, 512, 0, "bfloat16"),
    ("q_offset", 1, 512, 2048, 12, 12, 64, True, None, 1536, "bfloat16"),
]
MAIN_SHAPE = 0          # the shape the main path gives the kernel


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flash_phase(torch, fa, shape) -> dict:
    name, B, Sq, Sk, H, Hkv, hd, causal, window, q_offset, dt = shape
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, **kw)
    err = max((o.float() - o_ref.float()).abs().max().item(),
              (lse - lse_ref).abs().max().item())
    if not (torch.isfinite(o.float()).all() and err <= TOL[dt]):
        fail(f"flash_fwd {name} {dt}: max abs err {err} > {TOL[dt]}")

    # the library yardstick: one SDPA call on the same inputs (o only)
    qpos = q_offset + torch.arange(Sq, device="cuda")[:, None]
    kpos = torch.arange(Sk, device="cuda")[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    plain_causal = causal and window is None and q_offset == 0 and Sq == Sk
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=None if plain_causal else mask,
        is_causal=plain_causal, enable_gqa=Hkv != H)

    # the work this run's inputs need: unmasked (q, k) pairs, two products
    flops = 4.0 * B * H * hd * mask.sum().item()
    nbytes = (q.numel() + k.numel() + v.numel() + o.numel()) \
        * q.element_size() + lse.numel() * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES
    rec = {
        "shape": name, "B": B, "Sq": Sq, "Sk": Sk, "H": H, "Hkv": Hkv,
        "hd": hd, "causal": causal, "window": window, "q_offset": q_offset,
        "dtype": dt, "max_abs_err": err,
        "kernel_ms": cuda_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, **kw), 20),
        "plain_ms": cuda_ms(torch, lambda: fa.flash_attention_fwd_ref(
            q, k, v, **kw), 3),
        "library_ms": cuda_ms(torch, sdpa, 20),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    rec["kernel_tflops"] = flops / rec["kernel_ms"] / 1e9
    print(json.dumps({"flash_fwd": rec}), flush=True)
    return rec


def main() -> None:
    if not KERNELS.is_dir():
        fail(f"{KERNELS} not found: run from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)

    from repro_torch.kernels import backend
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import ReqState

    # 2. build
    t0 = time.perf_counter()
    logs = backend.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    recs = [flash_phase(torch, fa, s) for s in SHAPES]

    # 4. the main path
    fa.flash_attention_fwd.launches = 0
    runs = [serve("gpt-100m", 8, 512, 16, device="cuda"),
            serve("gpt-100m", 1, 300, 16, device="cuda")]
    launches = fa.flash_attention_fwd.launches
    cfg = get_config("gpt-100m")
    prefills = sum(r["prefills"] for r in runs)
    for r, n in zip(runs, (8, 1)):
        if not all(q.state is ReqState.DONE for q in r["requests"]):
            fail("a request did not finish")
        gen = r["generated"]
        if gen.shape != (n, 16) or gen.min() < 0 or gen.max() >= cfg.vocab:
            fail(f"generated tokens of shape {gen.shape} out of range")
        print(json.dumps({"serve": {
            "requests": n, "wall_s": r["seconds"],
            "tokens_per_s": r["tokens_per_s"],
            "ttft_wall_p50_ms": r["ttft_wall_p50_s"] * 1e3,
            "ttft_wall_p99_ms": r["ttft_wall_p99_s"] * 1e3,
            "simulated_s": r["report"]["sim_s"]}}), flush=True)
    if launches != cfg.n_layers * prefills or prefills != 9:
        fail(f"flash_fwd launched {launches} times for {prefills} prefills "
             f"of {cfg.n_layers} layers")

    # 5. the answer: f32 weights, the card against the CPU
    params = T.init_model(cfg, seed=0, device="cuda")
    f32 = lambda t: t.float() if t.is_floating_point() else t
    walk = lambda p, fn: {k: walk(v, fn) if isinstance(v, dict) else
                          [walk(x, fn) for x in v] if isinstance(v, list)
                          else fn(v) for k, v in p.items()}
    p_gpu = walk(params, f32)
    p_cpu = walk(p_gpu, lambda t: t.cpu())
    toks = torch.randint(0, cfg.vocab, (1, 45),
                         generator=torch.Generator().manual_seed(1))
    lg_gpu, _, _ = T.prefill(p_gpu, cfg, {"tokens": toks.cuda()}, 45)
    lg_cpu, _, _ = T.prefill(p_cpu, cfg, {"tokens": toks}, 45)
    diff = (lg_gpu.cpu() - lg_cpu).abs().max().item()
    scale = max(1.0, lg_cpu.abs().max().item())
    print(json.dumps({"logits_f32_card_vs_cpu": {
        "max_abs_diff": diff, "max_abs_logit": scale}}), flush=True)
    if not math.isfinite(diff) or diff > 1e-3 * scale:
        fail(f"f32 prefill logits differ by {diff} between card and CPU")

    main_rec = recs[MAIN_SHAPE]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:68",
        "launches": launches,
        "max_abs_err": main_rec["max_abs_err"],
        "ms": main_rec["kernel_ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
