"""The paper's explicit trees executed on ranks through the ``"p2p"``
Communicator of the PyTorch port: one ``batch_isend_irecv`` per tree
round (``repro_torch.core.tree_exec``) on 8 spawned ranks
(``repro_torch.launch.mesh.run_ranks``).

Counterpart of ``examples/tree_collectives_on_mesh.py``, on its topology
(2 pods of 2 boards of 2 chips, the reference's ``tpu_v5e_multipod(2, 2,
2)`` with its link classes): every rank deterministically constructs the
same multilevel tree from the coordinate table, then each round moves the
data, with one crossing of the slowest link in all.  Each rank holds one
value, its rank, as each device of the reference's mesh holds one.

On the card (the 8 ranks share it over gloo, staged through host memory,
where it is the only one):
  PYTHONPATH=src python examples/torch_tree_collectives_on_mesh.py
On the CPU:
  PYTHONPATH=src python examples/torch_tree_collectives_on_mesh.py \\
      --device cpu --smoke
(``--smoke`` changes nothing here: the example is small at any size.)
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Communicator, Level, Topology
from repro_torch.launch.mesh import choose_backend, run_ranks

# the reference's link classes of a TPU fleet (repro/core/topology.py)
LEVELS = [Level("dcn", latency=10e-6, bandwidth=6.25e9, overhead=2e-6),
          Level("ici_far", latency=3e-6, bandwidth=50e9, overhead=1e-6),
          Level("ici", latency=1e-6, bandwidth=100e9, overhead=0.5e-6)]


def multipod(pods: int = 2, boards: int = 2, chips: int = 2) -> Topology:
    """Strata (pod, board); the leaves are chips."""
    idx = np.arange(pods * boards * chips)
    return Topology(np.stack([idx // (boards * chips), idx // chips], 1),
                    LEVELS)


def rank_ops(rank: int, device: str) -> dict:
    """This rank's bcast from rank 3, reduce to rank 3 and allreduce of its
    own value, through the ``"p2p"`` backend; rank 0 also returns the
    bcast plan's rounds and the plan cache."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    comm = Communicator(multipod(), policy="paper", backend="p2p")
    plan = comm.plan("bcast", root=3)
    x = torch.tensor([float(rank)], device=dev)
    out = {"bcast": comm.bcast(x, root=3), "reduce": comm.reduce(x, root=3),
           "allreduce": comm.allreduce(x)}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["rounds"] = plan.rounds
    out["cache"] = comm.cache_info()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    topo = multipod()
    backend = choose_backend(None, torch.device(args.device), 8)
    res = run_ranks(rank_ops, 8, backend, (args.device,), timeout=300.0)
    rounds = res[0]["rounds"]
    print("tree rounds (src,dst per batch_isend_irecv):")
    for r, edges in enumerate(rounds):
        lv = [topo.levels[topo.comm_level(s, d)].name for s, d in edges]
        print(f"  round {r}: {edges}  links={lv}")
    col = lambda k: np.concatenate([o[k] for o in res])
    print("bcast from rank 3:", col("bcast"))
    print("reduce to rank 3:", col("reduce"), "(expect 28 at index 3)")
    print("allreduce:", col("allreduce"), "(expect 28 everywhere)")
    # the crossings of the slowest link class in the schedule, the paper's
    # metric; the plan is cached: these reads re-run no tree construction
    dcn = sum(1 for edges in rounds
              for s, d in edges if topo.comm_level(s, d) == 0)
    print(f"DCN crossings in the whole broadcast: {dcn}")
    print(f"plan cache: {res[0]['cache']}")


if __name__ == "__main__":
    main()
