"""Quickstart for the PyTorch port: the paper's multilevel topology-aware
collectives behind the one public entry point,
:class:`repro_torch.core.Communicator`, on the simulation plane.

Counterpart of ``examples/quickstart.py``, section by section: the Fig. 8
topology, the policies and their simulated broadcast times, the seven
collectives, the plan cache, segmented plans, the engine's overlapped
gradient sync and the simulated serving scheduler.  The planning plane is
exact against the reference, so every line after the title is the
reference example's.  It touches no device.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""
from repro_torch.core import Communicator, Engine, paper_fig8_topology
from repro_torch.core.engine import overlapped_step_times
from repro_torch.core.topology import magpie_site_view
from repro_torch.serving import (SLO, Scheduler, SimExecutor,
                                 default_compute_model, make_requests,
                                 poisson_arrivals)

print("repro_torch quickstart: the planning plane of the PyTorch port")


# 1. Describe the network as integer coordinate vectors (site, machine) —
#    here: the paper's own testbed, 16 procs on each of 3 machines, 2 sites.
topo = paper_fig8_topology()
print(topo)

# 2. One communicator per tree-selection policy.  Baselines build their
#    trees against a reduced *view* of the network; the simulator still
#    charges true per-edge costs.
comms = {
    "mpich-binomial": Communicator(topo, policy="oblivious"),      # MPICH
    "magpie-site": Communicator(topo, policy="paper",
                                view=magpie_site_view(topo)),      # MagPIe
    "multilevel": Communicator(topo, policy="paper"),              # the paper
}

# The multilevel plan crosses the WAN exactly once (paper Fig. 4):
ml = comms["multilevel"]
print(f"multilevel bcast plan: {ml.slow_crossings('bcast', nbytes=256e3)} "
      f"WAN edge(s); root serves its WAN child first: "
      f"{ml.plan('bcast', root=0, nbytes=256e3).tree.children[0][0]}")

# 3. Simulate a 256 KB broadcast on the postal model.
for name, comm in comms.items():
    t = comm.bcast(256e3, root=0).time
    print(f"{name:16s} bcast 256KB: {t*1e3:8.2f} ms")

# 4. Beyond the paper: per-level tree-shape selection (its §6 future work),
#    and the cost-model argmin over all candidates ("auto").
for policy in ("adaptive", "auto"):
    comm = Communicator(topo, policy=policy)
    t = comm.bcast(256e3, root=0).time
    print(f"{policy:16s} bcast 256KB: {t*1e3:8.2f} ms")

# 5. All seven collectives go through the same object:
for op in ("reduce", "gather", "scatter", "allreduce", "allgather"):
    rooted = op in ("reduce", "gather", "scatter")
    t = getattr(ml, op)(64e3, **({"root": 0} if rooted else {})).time
    print(f"{op:16s} 64KB multilevel: {t*1e3:8.2f} ms")
print(f"{'barrier':16s} multilevel: {ml.barrier().time*1e3:8.2f} ms")

# 6. Plans are cached — the second identical call rebuilds nothing:
before = ml.cache_info()
ml.bcast(256e3, root=0)
after = ml.cache_info()
print(f"plan cache: +{after.hits - before.hits} hit, "
      f"tree builds unchanged: {after.tree_builds == before.tree_builds}")

# 7. Large messages: plans LOWER to a segmented rounds IR, and the "auto"
#    argmin also searches bandwidth-optimal algorithms (scatter-allgather
#    bcast, reduce-scatter+allgather allreduce) — pipelined chunks cross
#    the WAN on parallel pair links instead of one saturated edge.
auto = Communicator(topo, policy="auto")
N = 64 * 2**20  # 64 MiB
plan = auto.plan("bcast", root=0, nbytes=N)
low = plan.lower(N)
print(f"64 MiB bcast plan: algorithm={plan.algorithm}, "
      f"{low.nchunks} chunks x {low.nsegs} segments, "
      f"{len(low.sends)} sends")
print(f"  unsegmented multilevel: {ml.bcast(N, root=0).time:8.2f} s")
print(f"  segmented auto plan:    {auto.bcast(N, root=0).time:8.2f} s")

# 8. The async engine: nonblocking handles, contention-aware concurrent
#    scheduling, and the bucketed OVERLAPPED gradient sync — all-reduce of
#    layer k rides under the backward compute of the layers below it.
L = 12
layer_bytes = [N / L] * L
t_comm = auto.allreduce(N).time
ov = overlapped_step_times(auto, layer_bytes, [t_comm / L] * L,
                           bucket_bytes=8 * 2**20)
print(f"64 MiB gradient sync, {ov['n_buckets']} buckets: "
      f"serial {ov['serial_s']:.2f} s -> overlapped "
      f"{ov['overlapped_s']:.2f} s ({ov['speedup']:.2f}x)")

eng = Engine(auto, policy="priority")
fat = eng.issue("bcast", N, root=0)              # fat weight broadcast...
ping = eng.issue("allreduce", 8e3,               # ...small op on site 0
                 members=tuple(range(16)))       #    jumps it (different
eng.wait_all()                                   #    member set: legal)
print(f"engine: small allreduce done at {ping.finished*1e3:.2f} ms while "
      f"the fat bcast runs until {fat.finished:.2f} s "
      f"(plans reused: {auto.stats().hits} cache hits)")

# 9. Serving: continuous batching on a paged KV cache, the engine pricing
#    each step's decode gathers against the periodic weight broadcast.
#    Open-loop Poisson arrivals; the "slo" policy admits by earliest TTFT
#    deadline and sheds requests whose deadline already passed.
arrivals = poisson_arrivals(rate=60.0, horizon_s=2.0, seed=0)
requests = make_requests(arrivals, vocab=512, prompt_len=(16, 48),
                         gen_len=(8, 24), slo=SLO(ttft_s=0.3, tpot_s=0.05))
sch = Scheduler(
    SimExecutor(block_size=16), n_blocks=1 + 8 * 16, block_size=16,
    max_slots=8, s_max=256, policy="slo", prefill_token_budget=256,
    compute_model=default_compute_model(1e9, flops_per_s=2e12),
    engine=Engine(auto, policy="priority", age_rate=N),
    replicas=[tuple(range(g * 16, (g + 1) * 16)) for g in range(3)],
    weight_bytes=N, gather_bytes=4096.0, bcast_every=64)
rep = sch.run(requests)
s = rep.summary()
print(f"serving: {s['n_done']}/{s['n_requests']} served "
      f"({s['n_shed']} shed) at {s['throughput_tok_s']:.0f} tok/s, "
      f"p99 TTFT {s['ttft_p99_s']*1e3:.0f} ms, "
      f"max {rep.max_concurrent} concurrent (paged KV, "
      f"{sch.alloc.capacity} blocks)")
