"""The dry run: every (arch x shape x mesh) cell on the production meshes,
on a host with no card, read against the H100's ceilings.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for the TPU meshes.  Here each cell runs as every model rank's own
program on the ``meta`` device, through the port's normal entry points
(``make_train_step``, ``make_prefill_fn``, ``make_decode_fn``) on the path
the card takes (``kernels.backend.on_card``), on a dry grid
(``Grid.dry``: rank m of the (pod 0, data 0) cell of the 16x16 data x
model mesh or the 2x16x16 pod x data x model one, ``launch/mesh.py:17-20``
of the reference).  Nothing is computed, nothing is communicated, and no
kernel is built: each hand-written kernel is counted by its work.  A cell
thus shows (a) that the sharding holds on the mesh (every rank program
builds, the reference's fallbacks included), (b) what a card holds
(``bytes_per_device``: the peak of the rank's live bytes), and (c) the
roofline terms, with the per-level collective census (``launch.census``),
the paper's own metric: bytes on the slow level.

Each data rank takes its ``global_batch / (pods * data)`` rows, or the
whole batch where that does not divide (the reference replicates it).
Ranks whose programs are alike (the same query and KV heads, the same
count of RWKV-6 heads met from the same offset inside the first, and for
the MoE the same even shares of its experts; ``rank_key``) run once; the
record is the maximum over the model ranks, its rank named.  The MoE's
group sizes cannot be read from a ``meta`` tensor: each expert takes an
even share of the routed rows (``layers.even_sizes``), and the record
says so (``"moe_sizes": "even"``).

Record keys are the reference's where the meaning holds; ``trace_s``
(the rank's wall time here) replaces ``compile_s``, ``gflops`` and
``gbytes`` (one card's: ``kernels.work.WorkCounter``, the FLOPs of
``FlopCounterMode``'s formulas plus the kernels' work, and each op's input
and output bytes) replace ``hlo_gflops`` and ``hlo_gbytes``, and
``fast_mb_per_chip``/``slow_mb_per_chip`` replace ``ici_``/``dcn_``.
``useful_flops_frac`` is the model's FLOPs (6 N D for training, 2 N D for
inference) over the card's times the cards.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all [--mesh both] [--comm multilevel]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from ..configs import get_config, list_archs
from ..configs.shapes import (SHAPES, ShapeSpec, applicable, cache_specs,
                              input_specs)
from ..core.costmodel import H100, roofline_terms
from ..kernels.work import WorkCounter
from ..models import layers as L
from ..models.convert import model_dims
from ..models.sharding import rank_heads, rwkv_heads
from ..models import transformer as T
from ..optim.adamw import OptConfig, init_opt_state, shard_opt_state
from ..tree import tree_leaves
from . import census as C
from .mesh import Grid
from .step import (abstract_params, make_decode_fn, make_prefill_fn,
                   make_train_step)

__all__ = ["PRODUCTION_MESHES", "RESULTS", "rank_key", "model_gflops",
           "run_rank", "dry_cell", "lower_cell", "main"]

# (pods, data, model) of the reference's production meshes
PRODUCTION_MESHES = {False: (1, 16, 16), True: (2, 16, 16)}
RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "dryrun_out", "dryrun.json")


def _rows(shape: ShapeSpec, world: int) -> int:
    B = shape.global_batch
    return B // world if B % world == 0 else B


def _moe_block(tokens: int) -> int:
    """The token block ``layers.moe_fwd`` routes at once."""
    chunk = L.MOE_CHUNK
    return tokens if tokens <= chunk or tokens % chunk else chunk


def rank_key(cfg, shape: ShapeSpec, world: int, model: int, m: int):
    """What rank m's program depends on: its query and KV heads
    (``rank_heads``: how many, and which KV head each reads), RWKV-6's
    heads that its columns meet and the offset of its first column in
    them (``rwkv_heads``), and, for the MoE, the even shares of its
    experts (every expert's where the axis does not divide them; an
    expert cut by its features is cut evenly, so that its ranks run
    alike).  Ranks of one key run alike."""
    if model == 1:
        return ()
    sh = rank_heads(cfg, model, m)
    key = (sh.nq, sh.nkv, sh.kv_of)
    if "rwkv6" in cfg.pattern:
        rw = rwkv_heads(cfg, model, m)
        key += (rw.nh, rw.off)
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        seq = 1 if shape.kind == "decode" else shape.seq_len
        n = _moe_block(_rows(shape, world) * seq) * cfg.moe.top_k
        el, lo = (E // model, m * E // model) if E % model == 0 else (E, 0)
        key += (tuple(L.even_sizes(n, E)[lo:lo + el]),)
    return key


def model_gflops(cfg, shape: ShapeSpec) -> float:
    """The model's GFLOPs a step (the reference's): 6 N D for training, 2
    N D for inference, N the active parameters, D the step's tokens."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * cfg.active_param_count() * tokens / 1e9


def _calls(grid: Grid) -> dict:
    return {a.name: {"calls": a.calls, "bwd_calls": a.bwd_calls,
                     "wire_bytes": a.wire_bytes} for a in grid.axes()}


def run_rank(cfg, shape: ShapeSpec, pods: int, data: int, model: int,
             m: int = 0, comm_mode: str = "multilevel",
             zero1: bool = True) -> dict:
    """Rank m of the (pod 0, data 0) cell of a (pods x data x model) grid
    runs one step of ``shape`` on ``meta``.  Returns its work (``flops``,
    ``bytes``, ``kernels``), its memory (``memory``: the peak of its live
    bytes, broken down as the reference's memory analysis: arguments,
    outputs, temporaries, aliased), its axes' counters (``calls``) and
    collective records (``records``), and ``trace_s``."""
    grid = Grid.dry(pods, data, model, m)
    tp = grid.tp
    world = pods * data
    rows = _rows(shape, world)
    specs = input_specs(cfg, shape)
    counter = WorkCounter(track_memory=True)
    S = shape.seq_len
    if shape.kind == "train":
        opt_cfg = OptConfig(comm_mode=comm_mode, zero1=zero1)
        params = abstract_params(cfg, model, m)
        mdims = model_dims(cfg, model) if tp is not None else None
        opt = shard_opt_state(init_opt_state(params, opt_cfg, n_slow=pods),
                              params, opt_cfg, grid, mdims)
        if shape.global_batch % world:     # every rank takes the batch
            specs = {k: torch.empty((world * rows,) + v.shape[1:],
                                    dtype=v.dtype, device="meta")
                     for k, v in specs.items()}
        step = make_train_step(cfg, opt_cfg, grid, "meta")
        args = (params, opt)
        counter.exclude(specs)               # the host's batch
        run = lambda: step(params, opt, specs)
    else:
        params = T.init_model(cfg, device="meta", model=model, m=m)
        put = lambda v: v[:rows].long() if not v.is_floating_point() \
            else v[:rows].clone()
        if shape.kind == "prefill":
            inputs = {k: put(v) for k, v in specs.items()}
            fn = make_prefill_fn(cfg, S, grid)
            args = (params, inputs)
            run = lambda: fn(params, inputs)
        else:
            cache = cache_specs(cfg, dataclasses.replace(
                shape, global_batch=rows), tp)
            tokens = put(specs["tokens"])
            fn = make_decode_fn(cfg, grid, s_max=S)
            args = (params, cache, tokens)
            run = lambda: fn(params, cache, tokens, S - 1)
    t0 = time.perf_counter()
    with counter:
        arg_bytes = counter.hold(args)
        if shape.kind == "train":
            out = run()
        else:
            with torch.inference_mode():
                out = run()
        arg_ids = {id(t.untyped_storage()) for t in tree_leaves(args)}
        out_st = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                  for t in tree_leaves(out) if isinstance(t, torch.Tensor)}
    trace_s = time.perf_counter() - t0
    out_bytes = sum(out_st.values())
    alias = sum(n for i, n in out_st.items() if i in arg_ids)
    peak = counter.peak_bytes
    return {
        "trace_s": trace_s, "flops": counter.flops, "bytes": counter.bytes,
        "kernels": counter.kernels,
        "memory": {"bytes_per_device": peak, "argument_bytes": arg_bytes,
                   "output_bytes": out_bytes, "alias_bytes": alias,
                   "temp_bytes": peak - arg_bytes - out_bytes + alias},
        "calls": _calls(grid), "records": grid.records(),
    }


def dry_cell(cfg, shape: ShapeSpec, pods: int, data: int, model: int,
             comm_mode: str = "multilevel", zero1: bool = True,
             every_rank: bool = False) -> dict:
    """Every model rank of one cell (one run per ``rank_key``, or each
    with ``every_rank``), read against the H100: the record of the rank
    with the largest ``step_s``, ``bytes_per_device`` the largest over the
    ranks (``bytes_rank`` names it), and each rank run under
    ``per_rank``."""
    world = pods * data
    chips, chips_per_pod = world * model, data * model
    reps: dict = {}
    for m in range(model):
        reps.setdefault(m if every_rank else
                        rank_key(cfg, shape, world, model, m), []).append(m)
    per = {}
    for members in reps.values():
        r = run_rank(cfg, shape, pods, data, model, members[0], comm_mode,
                     zero1)
        cens = C.census(r.pop("records"), chips_per_pod)
        terms = roofline_terms(      # one card's work, over one card
            flops=r["flops"], hbm_bytes=r["bytes"],
            fast_bytes=cens["fast_bytes"], chips=1, hw=H100,
            slow_bytes=cens["slow_bytes"])
        r.update(members=members, census=cens, terms=terms)
        per[members[0]] = r
    top = max(per, key=lambda m: per[m]["terms"]["step_s"])
    big = max(per, key=lambda m: per[m]["memory"]["bytes_per_device"])
    r = per[top]
    gflops = model_gflops(cfg, shape)
    rec = {
        "hw": H100.name, "rank": top, "trace_s": r["trace_s"],
        "bytes_per_device": per[big]["memory"]["bytes_per_device"],
        "bytes_rank": big, "memory": per[big]["memory"],
        "gflops": r["flops"] / 1e9, "gbytes": r["bytes"] / 1e9,
        "fast_mb_per_chip": r["census"]["fast_bytes"] / 1e6,
        "slow_mb_per_chip": r["census"]["slow_bytes"] / 1e6,
        "collective_counts": r["census"]["counts"],
        "calls": r["calls"],
        "kernels": r["kernels"],
        "model_gflops": gflops,
        "useful_flops_frac": (gflops * 1e9 / (r["flops"] * chips)
                              if r["flops"] else None),
        **r["terms"],
        "per_rank": {m: {"members": p["members"],
                         "bytes_per_device":
                             p["memory"]["bytes_per_device"],
                         "gflops": p["flops"] / 1e9,
                         "step_s": p["terms"]["step_s"],
                         "calls": p["calls"], "trace_s": p["trace_s"]}
                     for m, p in per.items()},
    }
    if cfg.moe is not None:
        rec["moe_sizes"] = "even"
    return rec


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               comm_mode: str = "multilevel", zero1: bool = True,
               parallel_block: bool = False,
               mesh: tuple[int, int, int] | None = None) -> dict:
    """One cell of the sweep on its production mesh (``mesh``, a (pods,
    data, model) triple, stands in for it); the roofline record, or
    ``{"skipped": why}`` where the cell does not apply."""
    cfg = get_config(arch)
    if parallel_block:
        cfg = dataclasses.replace(cfg, parallel_block=True)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"skipped": why}
    pods, data, model = mesh or PRODUCTION_MESHES[multi_pod]
    rec = dry_cell(cfg, shape, pods, data, model, comm_mode, zero1)
    name = "x".join(map(str, (pods, data, model) if pods > 1
                        else (data, model)))
    return {"arch": arch, "shape": shape_name, "mesh": name,
            "comm_mode": comm_mode, "zero1": zero1, **rec}


def _load(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save(res: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--comm", default="multilevel",
                    choices=["flat", "multilevel", "multilevel_compress"])
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--parallel-block", action="store_true",
                    help="PaLM-style parallel residual (perf variant)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default=None, help="results key suffix")
    ap.add_argument("--out", default=RESULTS,
                    help="the JSON the records accumulate in (default "
                    "dryrun_out/dryrun.json at the repository's root)")
    args = ap.parse_args(argv)

    archs = list_archs()[:10] if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    res = _load(args.out)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{'2x16x16' if mp else '16x16'}|" \
                      f"{args.comm}" + (f"|{args.tag}" if args.tag else "")
                if key in res and "error" not in res[key]:
                    print(f"SKIP (cached) {key}")
                    continue
                print(f"RUN {key} ...", flush=True)
                try:
                    rec = lower_cell(arch, shape, mp, args.comm,
                                     zero1=not args.no_zero1,
                                     parallel_block=args.parallel_block)
                    rec["tag"] = args.tag
                    res[key] = rec
                    msg = rec.get("skipped") or (
                        f"ok trace={rec['trace_s']:.1f}s "
                        f"bytes={rec['bytes_per_device'] / 1e9:.2f}GB "
                        f"bound={rec['bound']} step={rec['step_s']:.4f}s "
                        f"slow={rec['slow_mb_per_chip']:.1f}MB")
                    print(f"  -> {msg}", flush=True)
                except Exception as e:
                    failures += 1
                    res[key] = {"error": f"{type(e).__name__}: {e}",
                                "trace": traceback.format_exc()[-2000:]}
                    print(f"  -> FAIL {type(e).__name__}: {e}", flush=True)
                _save(res, args.out)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
