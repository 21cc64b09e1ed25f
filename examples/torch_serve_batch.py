"""Batched serving with the PyTorch port: prompts prefilled and decoded
greedily through the continuous-batching scheduler on a paged KV cache,
the model on the ranks of one model group (each rank its shard of the
weights; the ranks share one card over gloo where it is the only one).

Counterpart of ``examples/serve_batch.py``, through
``repro_torch.launch.serve.serve``.  Where the reference's mesh is 1x2x2
(batch over ``data``, the cache over ``model``), the default here is
1x1x2: the port serves one model group (ROADMAP.md, Queue 3 D).

On the card (qwen3-4b at full width, random weights from seed 0):
  PYTHONPATH=src python examples/torch_serve_batch.py [--arch qwen3-4b]
On the CPU, at the smoke size:
  PYTHONPATH=src python examples/torch_serve_batch.py --device cpu --smoke
"""
import argparse

from repro_torch.launch.serve import serve


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--mesh", default="1x1x2")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (4 layers, d 64)")
    args = ap.parse_args()
    out = serve(args.arch, args.requests, args.prompt_len, args.gen_len,
                mesh=args.mesh, smoke=args.smoke, device=args.device)
    print(f"[serve] {args.arch}: {out['generated'].shape[0]} requests x "
          f"{out['generated'].shape[1]} tokens in {out['seconds']:.2f}s "
          f"({out['tokens_per_s']:.1f} tok/s)")
    for i, row in enumerate(out["generated"][:2]):
        print(f"  req{i}: {row[:12].tolist()} ...")
    if "model_axis" in out:
        ma = out["model_axis"]
        print(f"  model axis of {ma['model']}: "
              f"{ma['collectives_per_prefill']:.0f} collectives a prefill, "
              f"{ma['collectives_per_decode_step']:.0f} a decode step; "
              f"staged bytes per rank {ma['staged_bytes']}")


if __name__ == "__main__":
    main()
