"""End-to-end distributed training with the PyTorch port: gpt-100m on a
2x2x1 grid of ranks, the multilevel gradient sync with int8 + error
feedback on the slow hop, ZeRO-1, checkpoints of the grid, and a pod
failure 60% of the way through with elastic recovery (two pods of two
ranks: losing one is below quorum, so the survivors restart from the
newest checkpoint onto 1x2x1 with twice the accumulation).

Counterpart of ``examples/train_e2e.py``.  On the card (the four ranks
share one card over gloo where it is the only one):
  PYTHONPATH=src python examples/torch_train_e2e.py [--steps 300]
On the CPU, at the smoke size (about 20 s):
  PYTHONPATH=src python examples/torch_train_e2e.py --device cpu --smoke
"""
import argparse
import tempfile

from repro_torch.launch.train import train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced gpt-100m config (4 layers, d 64)")
    ap.add_argument("--comm", default="multilevel_compress",
                    choices=["flat", "multilevel", "multilevel_compress"])
    args = ap.parse_args()
    steps = 30 if args.smoke and args.steps == 300 else args.steps

    with tempfile.TemporaryDirectory() as ckpt:
        out = train(
            arch="gpt-100m",
            steps=steps,
            mesh_spec="2x2x1",
            seq=128,
            batch=8,
            comm=args.comm,
            zero1=True,
            ckpt_dir=ckpt,
            ckpt_every=max(steps // 6, 1),
            # a pod fails 60% of the way through: the survivors shrink the
            # grid, restore the newest checkpoint and raise accumulation
            fail_at={int(steps * 0.6): [1]},
            smoke=args.smoke,
            device=args.device,
            log_every=max(steps // 15, 1),
        )
    first, last = out["losses"][0], out["final_loss"]
    print(f"\n[e2e] loss {first:.3f} -> {last:.3f} over {steps} steps, "
          f"{out['recoveries']} elastic recoveries, {out['repairs']} "
          f"in-place repairs, {out['stragglers']} straggler drops; "
          f"{out['world']} ranks left, accumulation x{out['accum']}")
    assert out["recoveries"] == 1, "the pod failure must restart the grid"
    assert last < first, "training must make progress"


if __name__ == "__main__":
    main()
