"""Serving in the port against ``repro.serving``: the copied host-side
pieces give the reference's exact results, the scheduler over the
``TorchExecutor`` emits the ``JaxExecutor``'s greedy tokens, and the serve
launcher runs end to end on the CPU.

Greedy tokens are compared exactly.  The models are bf16, and where the
two frameworks round a logit to neighbouring bf16 values a near-tie can
flip the argmax; the test then requires that the reference's top-2 logit
margin at the first divergence is below ``TIE_MARGIN`` (0.05, a few bf16
ulps of a logit near 1), i.e. that the divergence is a near-tie and not a
fault.
"""
import numpy as np
import pytest

from _torch_bridge import as_f32, jax_to_numpy
from repro import serving as jserving
from repro.configs import get_config
from repro.models import transformer as JT
from repro_torch import serving
from repro_torch.launch.serve import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ReqState

TIE_MARGIN = 0.05


def test_loadgen_copies_match_reference():
    arrivals = serving.poisson_arrivals(5.0, 4.0, seed=3)
    assert arrivals == jserving.poisson_arrivals(5.0, 4.0, seed=3)
    assert serving.bursty_arrivals(5.0, 4.0, seed=3) == \
        jserving.bursty_arrivals(5.0, 4.0, seed=3)
    kw = dict(vocab=97, prompt_len=(3, 30), gen_len=(1, 9), seed=7)
    ours = serving.make_requests(arrivals, **kw)
    ref = jserving.make_requests(arrivals, **kw)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert (a.rid, a.arrival_s, a.max_new_tokens) == \
            (b.rid, b.arrival_s, b.max_new_tokens)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_kv_cache_copies_match_reference():
    tables = [[3, 1], [], [4, 5, 6]]
    np.testing.assert_array_equal(
        serving.build_block_tables(tables, 4, n_slots=5),
        jserving.build_block_tables(tables, 4, n_slots=5))
    a, b = serving.BlockAllocator(9, 4), jserving.BlockAllocator(9, 4)
    for n, free in [(3, None), (2, [2]), (3, None), (1, [1, 3])]:
        assert a.alloc(n) == b.alloc(n)
        if free:
            a.free(free)
            b.free(free)
        assert a.n_free == b.n_free
    with pytest.raises(serving.OutOfBlocks):
        a.alloc(a.n_free + 1)


@pytest.mark.parametrize("policy", ["fifo", "slo"])
def test_scheduler_copy_matches_reference(policy):
    """SimExecutor under open-loop load: the same schedule, step for step."""
    out = []
    for mod in (serving, jserving):
        arr = mod.poisson_arrivals(40.0, 2.0, seed=1)
        reqs = mod.make_requests(arr, vocab=512, prompt_len=(4, 40),
                                 gen_len=(2, 12), slo=mod.SLO(0.2, 0.05))
        sch = mod.Scheduler(mod.SimExecutor(block_size=8), n_blocks=40,
                            block_size=8, max_slots=6, s_max=56,
                            policy=policy,
                            compute_model=mod.default_compute_model(1e8))
        rep = sch.run(reqs)
        out.append((rep.summary(), [(r.state.value, r.tokens) for r in reqs]))
    assert out[0] == out[1]


def _first_divergence(a, b):
    return next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)


def test_torch_executor_matches_jax_executor():
    """Mirror of ``tests/test_serving.py``'s greedy-equivalence test: the
    same prompts and weights through Scheduler + JaxExecutor and Scheduler
    + TorchExecutor, with variable prompt lengths, staggered finishes and
    slots recycled mid-run."""
    cfg = get_config("qwen3_4b", smoke=True)
    BS, s_max = 4, 24
    n_blocks = 1 + 2 * (s_max // BS)
    runs = []
    for mod in (jserving, serving):
        reqs = mod.make_requests([0.0] * 3, vocab=cfg.vocab, prompt_len=4,
                                 gen_len=4, seed=0)
        rng = np.random.default_rng(0)
        for r, L, g in zip(reqs, [3, 8, 5], [6, 3, 5]):
            r.prompt = rng.integers(0, cfg.vocab, (L,)).astype(np.int32)
            r.max_new_tokens = g
        kw = dict(n_blocks=n_blocks, block_size=BS, max_slots=2,
                  max_blocks=s_max // BS)
        if mod is jserving:
            ex = mod.JaxExecutor(cfg, None, seed=0, **kw)
            jparams = ex.params
        else:
            params = params_from_jax(jax_to_numpy(jparams), cfg,
                                     device="cpu")
            ex = mod.TorchExecutor(cfg, params, **kw)
        sch = mod.Scheduler(ex, n_blocks=n_blocks, block_size=BS,
                            max_slots=2, s_max=s_max,
                            prefill_token_budget=16)
        rep = sch.run(reqs)
        assert rep.max_concurrent == 2
        assert all(r.state.value == "done" for r in reqs)
        runs.append(reqs)
    assert len(ex.prefill_done_s) == 3
    for jr, tr in zip(*runs):
        if jr.tokens == tr.tokens:
            continue
        # a flip must be a bf16 near-tie in the reference's own logits
        i = _first_divergence(jr.tokens, tr.tokens)
        logits, cache, pos = JT.prefill(jparams, cfg,
                                        {"tokens": jr.prompt[None]},
                                        s_max=s_max)
        for t in jr.tokens[:i]:
            logits, cache = JT.decode_step(jparams, cfg, cache,
                                           np.array([[t]], np.int32), pos)
            pos += 1
        top2 = np.sort(as_f32(logits)[0, -1])[-2:]
        assert top2[1] - top2[0] < TIE_MARGIN, \
            f"request {jr.rid} diverged at token {i} without a near-tie"


def test_serve_end_to_end_on_cpu(tmp_path):
    trace = tmp_path / "serve.trace.json"
    metrics = tmp_path / "serve.prom"
    out = serve("gpt-100m", 3, 10, 4, smoke=True, device="cpu",
                trace=str(trace), metrics_out=str(metrics))
    assert out["generated"].shape == (3, 4)
    assert all(r.state is ReqState.DONE for r in out["requests"])
    assert out["prefills"] == 3 and out["report"]["n_done"] == 3
    assert out["tokens_per_s"] > 0 and out["ttft_wall_p50_s"] > 0
    assert trace.stat().st_size > 0
    assert "serve_done 3" in metrics.read_text()
    # the same weights and prompts give the same tokens
    again = serve("gpt-100m", 3, 10, 4, smoke=True, device="cpu")
    np.testing.assert_array_equal(out["generated"], again["generated"])
