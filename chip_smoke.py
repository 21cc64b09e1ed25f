#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line).
Each spawn of ranks costs seconds a rank before any work.  So every
rank forks from one server that imported torch and the port once, at
the script's start (``mesh.preload_ranks``), and the phases
that spawn ranks themselves share two spawns: the four ranks of 10, 12,
24d, 25c's 2x1x2 grid, 26f and 31 (``pool4_rank``, at phase 10) and the two
of 24c, 25c's 1x1x2 and 2x1x1 grids, 27d, 28 and 29 (``tp_rs_rank``,
at phase 24); each rank body sets its counters to 0 and reads them, and
each phase checks and prints its part where it stands:

1. the card: its name and power limit (nvidia-smi), torch and CUDA versions;
2. the build of every kernel under src/repro_torch/kernels/csrc (one nvcc
   per source, all started together), timed as set-up, and the count of
   tensor-core instructions (HMMA/HGMMA) in the SASS of each bf16 flash
   kernel (the forward and the two backward ones at every tile width,
   ``KERNEL_HEAD_WIDTHS`` 16-256), which must not be 0; the f32 kernels'
   counts are printed beside them, and every flash instantiation's
   registers and spills (``flash_ptxas``);
3. the flash forward kernel against its plain PyTorch version on the card,
   at the shapes of the models the port serves and trains (gemma3-12b's
   local layer at hd 256 among them, and the serving regimes of phases
   21-22: olmoe's prefill, recurrentgemma-2b's local layer (G 10, hd 256,
   window 2048, and on each rank of a model axis of 2: G 5, and of 4: G
   3, a rank's 2.5 heads computed as 3), seamless's
   encoder and cross attention (not causal, the cross with Sq != Sk),
   pixtral and llama4-scout (G 4, 5), and llama4-scout's rank on a model
   axis of 32 (phase 34: 2 heads on one KV head)), and in bf16
   also against the plain
   version that mirrors the tensor-core kernel's bf16 rounding of P, more
   tightly; its time in turns with the library call's (kernel, SDPA, SDPA,
   kernel; the library is timed only, never used by the port), in bf16
   also both device times (profiler), beside the plain version's time and
   the roofline bound; one JSON line per shape with the design it ran
   (``mma_bf16`` or ``fma_f32``);
4. the two flash backward kernels (dq, dk/dv) the same way, at the same
   shapes but the serving-only regimes, and at the local layers of
   recurrentgemma-2b's training (1 x 4096, G 10, hd 256, window 2048;
   and 1 x 2048 at G 5 and G 3, a rank's heads on a model axis of 2 and
   of 4) and
   gemma3-12b in bf16 and f32 (hd 256: the bf16 kernels' column split,
   the f32 kernels' 32-key tile): against the f32
   plain version, and in bf16 also against the plain version that mirrors
   the tensor-core kernels' bf16 rounding of P and dS, more tightly; the
   library call is SDPA's backward, timed on its own after one forward, in
   turns with the kernel (kernel, SDPA, SDPA, kernel), and its device
   kernels' names and summed time (profiler);
5. the serving path: ``repro_torch.launch.serve.serve`` on gpt-100m at full
   width (12 layers, d 768, random weights from a seed), 8 requests of 512
   prompt tokens and one ragged 300-token request, 16 new tokens each,
   with every launch counter set to 0 just before and read just after;
6. the serving answer: the same weights in f32 on the card and on the CPU
   give the same prefill logits for a ragged prompt;
7. the training path: ``repro_torch.launch.train.train`` on gpt-100m at
   full width, 5 steps of 8 x 1024 tokens, the counters again set to 0
   just before and read just after; remat runs each layer's forward twice,
   so a step launches flash_fwd twice per layer and each backward kernel
   once;
8. the training answer: gpt-100m at full width cut to 2 layers, f32
   weights from one seed, 3 steps on the card and on the CPU: the losses
   and one attention ``wq`` gradient agree;
9. the int8 kernels (quantise, dequantise, fused quantise + error
   feedback) against their plain versions on the card, bit for bit, at
   edge cases (ties, zero blocks, NaN, F32_MAX, ragged lengths) and at the
   main-path size, gpt-100m's 109,529,856-element gradient over data = 2,
   with their times beside the plain versions', the bytes bound and, for
   the dequant, the library's one-call product;
10. the multilevel collectives on a 2x2 grid of four ranks sharing the card
   (gloo, staged through host memory): ``multilevel_psum`` plain, int8
   and int8 + EF, bit for bit against the same sums done in this process;
11. the grid's training path: ``train`` on gpt-100m at full width, 2x2x1,
   ``multilevel_compress`` with ZeRO-1, 3 steps of 8 x 1024 tokens (2 rows
   per rank), each rank's launch counters starting at 0 in its fresh
   process and read at its end: every rank launches the fused EF kernel
   and the dequant kernel once per reference leaf (10) per step;
12. the grid's answer: 2 layers at full width, f32, 2x2x1,
   ``multilevel_compress``, 3 steps on four gloo ranks on the card, then
   the same ranks' grid on the CPU (phase 10's ranks): the
   losses agree, and so does Adam's first moment of a ``wq`` shard after
   the first two steps, which carries the synced gradient and the EF
   residual's effect;
13. the WKV kernel against its plain version on the card: o and the final
   state within 1e-4 of their scale, at the prefill shape of rwkv6-1.6b
   (8 x 512, 32 heads of 64), a 300-token request padded to 304 (whose
   final state must equal, bit for bit, that of the same request padded
   to 320), the reference kernel test's three shapes, and decays on the
   clip (w = 0.1923) and near 1; times beside the plain version's and the
   bound, the launch the kernel chose (blocks per head, blocks, threads,
   blocks an SM holds) and its registers and spills (ptxas), one JSON
   line per shape; at 8 x 512 and 1 x 304 also its time at 1, 2 and 4
   blocks a head.  Each ``--parent-wkv LIB`` (a shared library built from
   an earlier ``csrc/wkv.cu``) is held to the plain version there too,
   its o and state compared with the kernel's bit for bit
   (``parent_bits_equal``), and timed in turns with the kernel (kernel,
   parents, the parents in reverse, kernel);
14. the RWKV-6 serving path: ``make_prefill_fn``/``make_decode_fn`` on
   rwkv6-1.6b at full width (24 layers, d 2048, random weights from a
   seed), a batch of 8 prompts of 512 tokens and one of 300, 16 greedy
   tokens each, the counters set to 0 just before and read just after:
   24 WKV launches a prefill;
15. the RWKV-6 answer: rwkv6-1.6b at full width cut to 2 layers, f32
   weights, a 300-token prompt and 4 greedy steps on the card and on the
   CPU: the prefill's logits and cache, and each step's from the CPU's
   cache and token, agree leaf by leaf; a free run of the card's own cache
   holds its logits to the same tolerance;
16. the seven collectives by tree on 8 ranks sharing the card (gloo,
   staged through host memory): on the ``"p2p"`` backend over a topology
   of 2 pods of 2 boards of 2, the bcast of gpt-100m's bf16 parameters from
   rank 3 (219,059,712 bytes, twice: the second builds no tree and hits the
   plan cache), the all-reduce of its f32 gradient (438,119,424 bytes),
   reduce, gather and scatter at roots 0, 3 and 7, allgather (1 MiB per
   rank) and barrier, each held bit for bit to a replay in this process of
   the plans' ``Lowered.device_rounds()`` and ``tree_rounds`` folds, with
   the bytes each link level carried held to the plans' sends and the
   slow-level messages of each bcast to ``slow_crossings``; then on the
   ``"torch"`` backend of a 4 x 2 grid, the seven ops and
   ``allreduce_tree`` of gpt-100m's 10 leaves in ``"multilevel"`` and
   ``"multilevel_compress"``, without and with an EF residual, bit for bit
   where the summation order is fixed and within 1e-6 of max|ref| where
   gloo adds more than two terms its own way, every rank launching one
   quantise (or fused EF quantise) and one dequantise per compressed call.
   Each op's wall ms (the slowest rank), the bytes staged per rank, the
   bytes per link level and the plan cache are printed;
17. serving with the network plane, run right after phase 5 and in turns
   with it (5, 17, 17, 5): ``serve`` on gpt-100m at full width with
   ``mesh="2x2x1"`` (the plane's topology; the model runs on the card),
   ``monitor=True``, a Chrome trace and a metrics file, phase 5's
   requests, the counters set to 0 just before and read just after; its
   tokens must equal phase 5's, token for token, and so must the repeated
   phase 5's.  Printed: the weight-bcast estimate and its slow-link
   crossings (1), the engine demo's makespans (fifo, priority,
   serialised), the engine's issued, completed and batches counters, the
   monitor's events and last snapshot, the simulated TTFT beside the wall
   TTFT, tok/s, the flash-forward launches and each turn's wall s;
18. the train launcher's planning on a grid: ``train`` on gpt-100m at full
   width, 2x2x1 over gloo, ``multilevel`` with 25 MiB gradient buckets and
   a trace, 3 steps of 8 x 1024 tokens (phase 11's global batch), each
   rank's counters starting at 0 in its fresh process: finite losses, the
   setup estimate (``est_ms``, slow-link crossings) and the bucketed one
   (``n_buckets``, overlapped and serial ms), a trace that parses as
   JSON, and each rank's launches of #1-#3;
19. discovery on phase 16's 8 ranks: ``environment_topology`` from the
   ranks' node and card, timed point-to-point probes (``device_probes``,
   1 KiB and 1 MiB, staged through host memory as gloo's collectives are)
   whose (8, 8, 2) times every rank must hold alike, the topology fitted
   from them (``Communicator.from_probes``, persisted to a file), the
   ``"p2p"`` bcast of 1 MiB from rank 3 on it bit for bit against its
   replay in one process, and ``discover("device", path=)`` loading the
   same topology again without probing, in under a second.  The probes'
   minimum, median and maximum at each size, the fitted levels and
   ``nstrata`` are printed: eight ranks on one card, all over host-staged
   loopback, may well cluster as one flat level.
20. elastic training of gpt-100m at full width cut to 6 of its 12
   layers (to keep the whole run inside its time), ranks sharing
   the card over gloo (staged through host memory, as phase 11), each
   rank's counters starting at 0 in its fresh process.  20a: 4x1x1,
   ``multilevel_compress`` with ZeRO-1, 6 steps of 8 x 1024 tokens, pod 1
   failing before step 2 and a checkpoint every 3 steps: 6 finite losses,
   an in-place repair (``repairs`` 1, ``recoveries`` 0) and its report,
   the global batch fitted to 6 rows over the 3 survivors, the checkpoint
   of step 3 written from 3 pods (each EF leaf ``(3,) + shape``), and
   each survivor's launches of #1-#3 and of #5 and #6 (10 a step).  20b:
   2x2x1, ``multilevel`` with ZeRO-1, 8 steps, a checkpoint every 3 steps,
   pod 1 failing before step 7: below quorum, a restart from step 6 onto
   1x2x1 with accumulation 2 (``recoveries`` 1), the restored global
   state bit for bit the state gathered at the save of step 6 (SHA-256).
   20c: 2 layers at full width, f32, 4x1x1 ``multilevel_compress``, pod
   1 failing before step 2, 4 steps on four ranks on the card and on four
   gloo ranks on the CPU from the same weights: the losses agree to phase
   12's tolerance.  Printed: each case's wall s, step ms, recovery s,
   each save's bytes and seconds (the gather and host copy) and each
   write's on disk.
21. the MoE main path: ``serve`` on olmoe-1b-7b at full width and depth
   (16 layers, d 2048, 64 experts top-8; 6.82 B parameters, random from a
   seed), phase 5's requests, the counters and ``moe_fwd.host_syncs`` set
   to 0 just before and read just after: every request done, 16 flash
   launches a prefill; wall s, tok/s, wall TTFT and the host syncs a
   scheduler step printed; then one 8 x 512 prefill under torch.profiler:
   the card's ms in flash, in the expert products, in the router and
   sort, and in the rest, beside the route's host ms;
22. the dense path (``make_prefill_fn``/``make_decode_fn``) at full
   width: recurrentgemma-2b (4 x 512, then 1 x 2048, whose decode wraps
   the local layers' 2048-slot ring), seamless-m4t-medium (4 requests of
   512 encoder frames and 128 decoder tokens), pixtral-12b (4 x (256 patch
   embeds + 256 tokens)) and llama4-scout-17b-a16e cut to 4 of its 48
   layers (the whole does not fit one card), 16 greedy tokens each, the
   counters set to 0 before each config and read after: finite logits,
   tokens in range, a flash launch per attention layer (encoder and cross
   layers included) and prefill; prefill ms and decode ms a step;
23. the five configs' f32 answer, card against CPU, at full width and one
   pattern period (llama4-scout, olmoe, pixtral 2 layers, recurrentgemma
   3, seamless 2 + 2): 2 prompts of 48 tokens (after 32 patch embeds or
   encoder frames), the prefill's logits and cache and 4 decode steps,
   each from the CPU's cache and token, within 1e-4 of their scale (bf16
   cache leaves within one ulp); every MoE call's top-k experts, token by
   token, different only at near-ties (printed per layer);
24. serving on a model axis, the M ranks of one model group sharing the
   card over gloo (staged through host memory), each a fresh process
   holding its shard of the weights (random from a seed, the one-rank
   model's): 24a ``serve`` on gpt-100m at full width with ``mesh``
   ``1x1x2``, 24b on olmoe-1b-7b at full depth on ``1x1x4``
   (16 experts a rank, expert-parallel at its capacity_factor 1.25),
   both with phase 5's batch of 8 requests (one ``serve`` call each: a
   call spawns its ranks); 24c the dense path
   (``make_prefill_fn``/``make_decode_fn`` with the grid) on gemma3-12b
   cut to its first pattern period (5 windowed layers, 1 global) on
   ``1x1x2``, 4 x 512 and 1 x 2048 prompts whose decode wraps the
   1024-slot ring, 16 greedy tokens, the caches split over the sequence;
   each against the one-rank run of the same requests (phases 5 and 21,
   and the dense path in this process): every request done, the first
   prefill's bf16 logits within 5e-2, each rank's flash launches (one a
   layer and prefill, on its heads), printed with wall s, tok/s, TTFT,
   the model axis's collectives a prefill and a decode step, the bytes
   each rank staged, the MoE's dropped slots per layer and the token
   agreement.  24d (phase 10's 4 ranks, the first group of 2 for M 2):
   the three configs at full width and their smoke
   configs' depth in f32 on the card (the MoE with room for every slot),
   each model group against the one-rank model: the paged and the dense
   prefill's logits within 1e-5, each paged decode step (pools of the
   rank's KV heads) and each dense decode step (the sequence-parallel
   decode where the model axis divides the cache) from the one-rank
   pools or cache within 1e-4, no slot dropped;
25. training on a model axis, the ranks sharing the card over gloo
   (staged through host memory), each a fresh process holding its model
   shard (random from a seed) and its counters starting at 0, read at its
   end: 25a ``train`` on gpt-100m at full width and depth with ``mesh``
   ``1x2x2``, ``multilevel`` with ZeRO-1, 4 steps of 8 x 1024 tokens
   (tensor-parallel forward and backward, the vocab-parallel loss, the
   sync over data beside the model shards); 25b ``2x1x2``
   ``multilevel_compress``, so that the fused EF quantiser and the
   dequantiser run on each rank's model shard: finite losses, every
   rank's launches of #1-#3 (2, 1, 1 a layer and step) and of #5 and #6
   (10 a step: one per stacked leaf), the same model-axis collectives on
   each step; printed with wall ms a step after the first and tok/s
   beside phases 7 and 11, the model axis's collectives a step (forward,
   the remat's re-run, backward), the bytes staged a rank and the slow
   axis's bytes beside f32's.  25c, the f32 answer: gpt-100m at 2 layers
   and full width, ``multilevel``, unclipped, 2 steps of 4 x 128 on
   1x1x2 and 2x1x2 on the card and on the CPU, against one rank and
   2x1x1 on the card: the losses within 1e-4 relative.  25d: qwen3-4b at
   full width cut to 4 layers (its 151,936-word tied head vocab-sharded,
   q/k norms, G 4 on each rank) on 1x1x2 in bf16, 2 steps of 2 x 1024:
   finite losses, the first within 1e-2 relative of the one-rank run's;
26. training the MoE, RG-LRU, enc-dec and frontend configs on one rank
   through ``train``, bf16, random weights from a seed, the counters and
   the MoE's host syncs set to 0 just before each and read just after:
   26a recurrentgemma-2b at full width and depth (26 layers, d 2560,
   vocab 256,000; 8 local layers of 10 heads of 256 on one KV head,
   window 2048), 3 steps of 1 x 4096, so that the window bites in the
   backward, the full-width path; 26b seamless-m4t-medium at full width
   and depth (12 + 12 layers, the audio ``src_embeds``), 2 steps of 4 x
   (512 frames + 512 tokens); 26c olmoe-1b-7b at full width cut to 4 of
   16 layers, 2 steps of 2 x 1024; 26d pixtral-12b cut to 4 of 40 layers
   with its 256 patch embeds, 2 steps of 2 x 1024: finite losses, a flash
   launch per attention call and step (twice for the forward, remat),
   two host reads of the routing a MoE layer and step; printed with the
   parameter count, each step's wall ms and loss, peak memory.  26e, the
   answer: the five configs at full width (recurrentgemma one pattern
   period, so the f32 hd-256 backward runs; olmoe and pixtral one layer;
   seamless 1 + 1; llama4-scout at its smoke size) in f32, the training
   step's loss and gradient (``step.loss_and_grads``: the forward, the
   remat's re-run and the backward) on 1 x 256 tokens on the card and on
   the CPU: the loss within 1e-5 relative, each gradient leaf within 1e-4
   of its largest (Adam's first moment after the step is 0.1 x the
   clipped gradient; the CPU's AdamW over every leaf is left out, for the
   whole script's time).
   26f: olmoe-1b-7b at full width cut to 1 layer, f32, on 2x2x1 ranks
   sharing the card over gloo (phase 10's ranks),
   ``multilevel_compress`` with ZeRO-1, 2 steps, against one rank on the
   card (1e-4 relative): #5 and #6 once a stacked leaf (the expert leaves
   included) a step on each rank.
27. training RWKV-6 on one rank, and the MoE and frontend configs on a
   model axis, the counters and the MoE's host syncs set to 0 just before
   each and read just after (the spawned ranks' from 0 in their fresh
   processes): 27a ``train`` on rwkv6-1.6b at full width and depth (24
   layers, d 2048, vocab 65,536), bf16, 3 steps of 8 x 512 (the serving
   prefill's shape): finite losses and two WKV launches a layer and step
   (the forward and the remat's re-run; the backward is autograd through
   the plain scan, recomputed from the saved inputs), printed with each
   step's wall ms and loss, tok/s and peak memory; 27b, the answer:
   rwkv6-1.6b at full width cut to 2 layers in f32, the loss and
   gradient on the card and on the CPU as 26e holds them;
   27c ``train`` on olmoe-1b-7b at full width cut to 4 of 16 layers on
   ``1x1x2`` ranks sharing the card over gloo (32 experts a rank), bf16,
   2 steps of 2 x 1024: finite losses, each rank's flash launches (2, 1,
   1 a layer and step), its host reads of the routing (2 a layer and
   step), the slots each layer dropped, the model axis's collectives a
   step, the bytes staged, step ms beside 26c's one rank and each rank's
   peak memory; 27d (the ranks of 24c and 28), the answer on the axis:
   olmoe-1b-7b and pixtral-12b at full width cut to 1 layer in f32 on
   ``1x1x2`` at a capacity factor
   that drops nothing, one unclipped step against one rank on the card:
   the loss within 1e-4 relative, Adam's first moment within 1e-4 of each
   leaf's largest.
28. RWKV-6 and the enc-dec config on a model axis, the two ranks of
   ``1x1x2`` sharing the card over gloo, each a fresh process holding its
   shard (random from a seed) and its counters starting at 0, read at its
   end (24c's, 27d's and the phase's ranks are one spawn): 28a
   rwkv6-1.6b and 28b
   seamless-m4t-medium at full width and depth through
   ``make_prefill_fn``/``make_decode_fn`` with the grid, a 2 x 512
   prompt (seamless after 512 encoder frames) and 8 greedy decode steps,
   against the one-rank run on the same weights: the ranks' tokens equal,
   the first prefill's bf16 logits no farther from the same weights' f32
   logits on one rank than the one-rank bf16 run's are, plus 5e-2, each
   rank's WKV launches (one a layer and prefill, on its 16 heads) or
   flash launches (encoder, decoder and cross attention on its heads);
   printed with the tokens beside the one-rank run's, the WKV launch
   plan, prefill and decode ms beside one rank's, the collectives a
   prefill and a step, the bytes staged.  28c trains on ``1x1x2``
   (``make_train_step`` with ``train``'s settings) in bf16, 3 steps of
   2 x 512: rwkv6-1.6b cut to 4 of 24 layers and seamless whole (12 +
   12 layers): finite
   losses, the same collectives each step, each rank's launches (2 WKV a
   layer and step; 2, 1, 1 flash an attention call and step), printed
   with step ms beside 27a's and 26b's one rank, tok/s, peak memory a
   rank and the bytes staged.  28d, the answer: rwkv6-1.6b (2 layers)
   and seamless (1 + 1) at full width in f32 on ``1x1x2`` against one
   rank on the card: the dense prefill's logits within 1e-5, 4 decode
   steps from the one-rank cache within 1e-4, one unclipped step's loss
   within 1e-4 relative and Adam's first moment within 1e-4 of each
   leaf's largest.
29. The RG-LRU family and the KV-head split on a model axis, on phase
   28's ranks: 29a recurrentgemma-2b whole (26 layers, d 2560, one KV
   head cut inside it, 5 query heads a rank; the RG-LRU on 1280
   channels a rank, ``w_out`` on its run's layers) as 28a, its tokens
   also equal to the one-rank run's; 29b trains it at full width cut to
   3 layers (one whole period: its run of two RG-LRU layers, so that
   ``w_out``'s run-dim gather runs; 6 until a whole run passed 1000 s)
   as 28c; 29c holds it at 3 layers in f32 as 28d, its decode steps
   within 1e-5.
30. Elastic training on a model axis, through ``train``, which spawns its
   own six ranks (a rank that has left can make no group a shared spawn
   makes later): 30a gpt-100m at full width cut to 2 layers, bf16, on
   ``3x1x2`` sharing the card over gloo, ``multilevel_compress`` with
   ZeRO-1, 6 steps of 6 x 256, a checkpoint every 2 steps; pod 1 of 3
   fails before step 2 (a quorum holds: an in-place repair, each survivor
   carrying its model shard), pod 1 of the 2 left before step 4 (below
   quorum: a restart from step 2's checkpoint onto ``1x1x2`` with accum
   2).  The decisions, 7 finite losses, the tokens a step, the saves
   (steps 2 and 4 from 2 and 1 pods, their EF leaves leading with those
   pods), the restore (bit for bit the state gathered at step 2's save)
   and the two survivors' model-axis collectives, equal step by step, are
   the reference's 3x1x1 decisions that ``tests/test_torch_tp_elastic.py``
   holds the port to; each survivor's launches are counted (10
   micro-steps: the flash kernels on its 6 heads, the EF and dequant
   kernels in the 4 steps with a slow axis).  Printed: step ms,
   ``recovery_s``, each save's bytes and seconds, the bytes staged a
   step, the peak memory a rank, the wall.
31. A model axis that cuts inside a head, and a vocabulary it does not
   divide, on phase 10's four ranks (``pool4_rank``: the ranks compute
   there, this phase checks): recurrentgemma-2b on ``1x1x4``, 640 of its
   2560 query columns a rank (2.5 of its 10 heads of 256; the rank gathers
   q by columns and computes the 3 heads its columns meet), its one KV head
   gathered, the RG-LRU on 640 channels a rank. 31a serves it whole as 29a,
   against 29a's one-rank run: its 5 tokens equal the first 5 of 29a's (9
   until whole runs passed 1000 s), its first prefill's bf16 logits as 29a
   holds them but for one bf16 step of the largest logit (0.25 at 42.7,
   where LOGIT_TOL is below the logits' own resolution), and the same
   weights' f32 prefill on the ranks within TP_F32_TOL of one rank's, all
   26 layers; 31b trains it at 3 layers as 29b, 2 steps (3 until a whole
   run passed 1000 s); 31c holds it at 3 layers in f32 as 29c; 31d holds
   seamless-m4t-medium (1 + 1 layers, its 256,206 vocabulary rows, which 4
   does not divide, replicated with the tied head) as 28d. Each rank's
   flash launches are asserted: 8 forwards in 31a; 4, 2 and 2 in 31b; 3, 1
   and 1 in 31c; 9, 3 and 3 in 31d.
32. The dry run (``repro_torch.launch.dryrun.run_rank``: each cell on the
   ``meta`` device, nothing computed, the kernels counted by their work)
   against the card, computed in a CPU subprocess that this script starts
   at its beginning (``--dry-runs``): 32a phase 7's one-rank step of
   gpt-100m (8 x 1024, bf16), whose ``bytes_per_device`` must lie within
   0.85-1.15 of phase 7's ``torch.cuda.max_memory_allocated``; 32b those
   of 26a (recurrentgemma-2b whole, 1 x 4096) and 27a (rwkv6-1.6b whole,
   8 x 512), printed beside the card's peaks with their breakdown
   (arguments, outputs, temporaries, aliased); 32c 31b's cell
   (recurrentgemma-2b, 3 layers, 2 x 512, 1x1x4), whose every rank's
   calls, backward calls and wire bytes of every axis must equal what that
   rank of 31b counted on the card in each step.
34. The cuts inside a unit on a model axis of 32 ranks forked for it
   (``inside_rank``): llama4-scout-17b-a16e at full width, its weights
   drawn part by part from a seed so that each rank draws its own shard
   (``drawn_params``), the memory reckoned and printed first, the one-rank
   runs made and freed before the ranks start.  34a serves 2 of its 48
   layers, a 1 x 512 prompt and 4 new tokens, on the dense path (the
   sequence-parallel decode) and on the paged path: every rank's tokens
   equal the one-rank run's, its bf16 first logits as 31a's bound holds
   them, the same weights' f32 prefill within TP_F32_TOL, the collectives
   of a prefill and of a step as INSIDE_CALLS predicts them, each rank's
   flash launches (2 a prefill); 34b one f32 ``loss_and_grads`` of 1 layer
   at 1 x 256: the loss within 1e-5 relative of one rank's and equal on
   the ranks, the gradients of ``w_in``, ``w_gate`` and ``w_out`` (128
   rows of every expert of every rank's shard, and each leaf's largest
   entry) within 1e-4 of the leaf's largest entry, the collectives and the
   flash launches (2, 1 and 1) as counted; 34c the WKV kernel against its
   plain version at a rank of rwkv6-1.6b on M 64 (one head of 64, 2 x
   512).  Printed with the card's name and power limit, staged bytes,
   peak memory a rank, prefill and decode ms beside one rank's.
35. Head dims other than 16, 32, 64, 128 and 256 (run right after 3-4):
   the three flash kernels at hd 48, 80 and 96 (their widths' exact
   instances) and 72, 100, 33 and 200 (padded instances: rows 16-, 8- and
   2-byte aligned; 200 at width 224) (``WIDTH_SHAPES``: GQA, a window, an
   offset, ragged lengths) in bf16 and f32 against their plain versions
   and the bf16 mirrors, as 3-4 hold them;
   ``layers.chunked_attention`` forward and backward through autograd at
   phi-3-mini's shape (32 heads of 96, 1 x 2048, causal, bf16), its
   launches counted from 0 (one of each kernel) and its o, dq, dk, dv held
   to the plain versions; phi-3-mini's and phi-2's (32 of 80) shapes
   timed as in 3-4, and 32 heads of 72 and of 100 (padded to 80 and 112),
   with the share of the work that padding to the tile width adds.  ``python3
   chip_smoke.py --phase-35`` builds the kernels, checks their SASS and
   runs it alone.
36. The WKV kernel's other instances (run right after 15): head dims
   80-256 at chunk 16 and chunks 1-64 at hd 64 (tests/test_torch_wkv.py's
   cases), rwkv6-1.6b's 8 x 512 prefill widths with 16 heads of 128 and
   8 of 256, and padded chunks and heads (``WKV_WIDE_SHAPES``) against
   the plain version, o and the final state within WKV_TOL of their
   scale; at each, o and the state bit for bit across n_split 1, 2, twice
   the head's floor and the launcher's choice, and a padded chunk or head
   bit for bit against the exact instance on the inputs padded by the
   caller; each shape's time beside the plain version's and its bound,
   its launch plan and its instance's registers and spills, one JSON line
   each.  Then rwkv6-1.6b's widths with heads of 128 (16 heads), 2 layers
   in f32, a 2 x 512 prefill and 4 greedy tokens through
   ``make_prefill_fn``/``make_decode_fn`` held to the CPU as phase 15
   holds hd 64's, its WKV launches counted (2, added to #7's line).
   ``python3 chip_smoke.py --phase-36`` builds the kernels and runs it
   alone.

Phases 3, 4, 9, 13 and 36 take their bounds from
``repro_torch.core.costmodel.kernel_roofline`` (the H100's datasheet
ceilings, ``H100`` for bf16 and ``H100_F32`` for f32) and the kernels'
work from the port (``flash_attention.fwd_work``/``bwd_dq_work``/
``bwd_dkv_work``, ``quant.work``, ``wkv.work``); each record also gives
the fractions of the peak rates its time achieved, and after phase 13 the
``refit_hw`` H100 that the best of them give is printed.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  TF32 is off throughout.
"""
import argparse
import atexit
import ctypes
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
# what the ranks' fork server imports once: every rank plans its sync
# under a fake-tensor mode, which imports torch._dynamo
RANK_PRELOAD = ("numpy", "torch._dynamo", "repro_torch.launch.train",
                "repro_torch.launch.serve")

# (tolerance on o and lse, the kernel tests' own: f32 3e-5, bf16 2e-2)
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
# (tolerance on dq, dk, dv relative to max|ref|)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# bf16 o, dq, dk, dv against the plain versions that mirror the kernels'
# bf16 rounding of P (and dS), relative to max|mirror|: the mirrors return
# f32, so what is left is the kernels' rounding of their output to bf16, at
# most half a bf16 ulp, 2**-8 = 3.9e-3 of max|mirror|, and f32 sums in
# another order (about 1e-6 of it).  A key tile left out moves a row's
# output or gradient by far more.
MIRROR_TOL = 4e-3
# the forward's lse against its mirror, relative to max(1, max|lse|): it is
# not rounded to bf16, so only f32 sums and exp2 against exp differ
LSE_MIRROR_TOL = 1e-4
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
    ("gpt-100m train", 8, 1024, 1024, 12, 12, 64, True, None, 0, "bfloat16"),
    ("gpt-100m train", 8, 1024, 1024, 12, 12, 64, True, None, 0, "float32"),
    ("gemma3-12b local", 1, 2048, 2048, 16, 8, 256, True, 1024, 0, "bfloat16"),
    # the serving regimes of phases 21-22 (forward only)
    ("olmoe-1b-7b prefill", 1, 512, 512, 16, 16, 128, True, None, 0,
     "bfloat16"),
    ("recurrentgemma-2b local", 1, 2048, 2048, 10, 1, 256, True, 2048, 0,
     "bfloat16"),
    ("seamless-m4t-medium encoder", 4, 512, 512, 16, 16, 64, False, None, 0,
     "bfloat16"),
    ("seamless-m4t-medium cross", 4, 128, 512, 16, 16, 64, False, None, 0,
     "bfloat16"),
    ("pixtral-12b", 4, 512, 512, 32, 8, 128, True, None, 0, "bfloat16"),
    ("llama4-scout", 4, 512, 512, 40, 8, 128, True, None, 0, "bfloat16"),
    # the local layers at hd 256 in training (phase 26): the backward's
    # column split (bf16) and 32-key tile (f32)
    ("recurrentgemma-2b train", 1, 4096, 4096, 10, 1, 256, True, 2048, 0,
     "bfloat16"),
    ("recurrentgemma-2b train", 1, 4096, 4096, 10, 1, 256, True, 2048, 0,
     "float32"),
    ("gemma3-12b local", 1, 2048, 2048, 16, 8, 256, True, 1024, 0,
     "float32"),
    # recurrentgemma-2b's local layer on a rank of a model axis of 2: 5
    # query heads on the one KV head (phase 29)
    ("recurrentgemma-2b local M 2", 1, 2048, 2048, 5, 1, 256, True, 2048, 0,
     "bfloat16"),
    ("recurrentgemma-2b local M 2", 1, 2048, 2048, 5, 1, 256, True, 2048, 0,
     "float32"),
    # and of 4: the 3 heads that a rank's 640 query columns meet (phase 31)
    ("recurrentgemma-2b local M 4", 1, 2048, 2048, 3, 1, 256, True, 2048, 0,
     "bfloat16"),
    ("recurrentgemma-2b local M 4", 1, 2048, 2048, 3, 1, 256, True, 2048, 0,
     "float32"),
    # llama4-scout on a rank of a model axis of 32 (phase 34): the 2 query
    # heads of 128 that every rank's 160 columns meet (one cut inside),
    # both in one KV head's group of 5
    ("llama4-scout M 32", 1, 512, 512, 2, 1, 128, True, None, 0,
     "bfloat16"),
]
# phase 35: head dims other than 16, 32, 64, 128 and 256, each run at the
# least width that holds it (``fa.kernel_width``): 48, 80 and 96 at their
# own (the exact instances), 72, 100, 33 and 200 below one (the padded
# instances; rows 16-, 8- and 2-byte aligned; 200 at width 224, the design
# above 128); GQA, a window, an offset and ragged lengths among them;
# (name, B, Sq, Sk, H, Hkv, hd, causal, window, q_offset), each in bf16
# and f32
WIDTH_SHAPES = [
    ("hd 48", 1, 300, 300, 8, 8, 48, True, None, 0),
    ("hd 72 G 4", 1, 300, 300, 8, 2, 72, True, None, 0),
    ("hd 80 non-causal", 1, 300, 300, 8, 8, 80, False, None, 0),
    ("hd 96 window offset", 1, 256, 512, 8, 2, 96, True, 100, 256),
    ("hd 100 ragged window", 2, 333, 333, 8, 2, 100, True, 100, 0),
    ("hd 33 offset", 1, 128, 384, 4, 1, 33, True, None, 256),
    ("hd 200 G 10", 1, 300, 300, 10, 1, 200, True, 128, 0),
]
# and timed, with SDPA: phi-3-mini's attention (32 heads of 96,
# hf:microsoft/Phi-3-mini-4k-instruct) and phi-2's (32 of 80), MHA,
# 1 x 2048, causal, each at its own tile width; the first also through
# layers.chunked_attention; and 32 heads of 72 and of 100 at that shape,
# below their widths (80, 112: the kernels' padded instances; 100 % 8 != 0
# stages rows an element at a time)
WIDTH_TIMED = [
    ("phi-3-mini", 1, 2048, 2048, 32, 32, 96, True, None, 0, "bfloat16"),
    ("phi-2", 1, 2048, 2048, 32, 32, 80, True, None, 0, "bfloat16"),
    ("hd 72 padded", 1, 2048, 2048, 32, 32, 72, True, None, 0, "bfloat16"),
    ("hd 100 padded", 1, 2048, 2048, 32, 32, 100, True, None, 0,
     "bfloat16"),
]
MAIN_SHAPE = 0          # the shape the serving path gives the forward
TRAIN_SHAPE = 12        # the shape the training path gives all three
# phase 4 runs these; the others serve only
BWD_SHAPES = set(range(15)) | {21, 22, 23, 24, 25, 26, 27}
TRAIN = dict(steps=5, seq=1024, batch=8)
PEAK_GB = {}            # the card's peak memory of phases 7, 26a and 27a
GRID_TRAIN = dict(steps=3, seq=1024, batch=8, mesh_spec="2x2x1",
                  comm="multilevel_compress", dist_backend="gloo")
GPT_100M_PARAMS = 109_529_856
QUANT_MAIN_N = GPT_100M_PARAMS // 2   # the gradient over data = 2
COLL_N = 1_000_448      # divides by 2 and 256, its shard not by QTILE
# The grid's f32 answer, card against CPU: the losses (7.2e-8 apart when
# measured), and Adam's first moment of the layer-0 wq shard after steps 1
# and 2, which is the synced gradient (x 0.1 x clip / ranks) and then
# mixes in the second one, EF residual included.  Where a pod's q rounds
# the other way on the two devices the element moves by a scale step, so
# what is bounded is the share of elements that differ by more than
# GRID_M_REL of the leaf's largest |m| (f32 noise is about 1e-6 of it).
GRID_LOSS_TOL = 1e-6    # relative
GRID_M_REL = 1e-4
GRID_M_SHARE = 1e-3
# (name, B, S, H, hd, decays); S of the ragged request before its pad
WKV_SHAPES = [
    ("rwkv6-1.6b prefill", 8, 512, 32, 64, "model"),
    ("ragged 300 -> 304", 1, 300, 32, 64, "model"),
    ("kernel test", 2, 64, 2, 16, "test"),
    ("kernel test", 1, 128, 4, 32, "test"),
    ("kernel test", 1, 64, 1, 64, "test"),
    ("decay clip", 1, 512, 32, 64, "clip"),
    ("decay near 1", 1, 512, 32, 64, "one"),
]
# phase 36: the instances beside (chunk 16, width 64): (name, B, S, H, hd,
# chunk, decays): tests/test_torch_wkv.py's head dims 80-256 at chunk 16 and
# chunks 1-64 at hd 64 (the decay clip only up to chunk 16), rwkv6-1.6b's
# prefill widths with heads of 128 and of 256, and padded instances (a
# chunk or a head below its instance's: hd 100 in chunks of 24, 72 in 12,
# 200, 33 in chunks of 40, 7 in chunks of 5)
WKV_WIDE_SHAPES = [
    ("hd 80", 1, 32, 2, 80, 16, "model"),
    ("hd 96", 1, 48, 1, 96, 16, "test"),
    ("hd 128", 1, 32, 2, 128, 16, "clip"),
    ("hd 256", 1, 32, 1, 256, 16, "model"),
    ("chunk 1", 1, 32, 2, 64, 1, "clip"),
    ("chunk 4", 2, 32, 1, 64, 4, "test"),
    ("chunk 8", 1, 64, 2, 64, 8, "clip"),
    ("chunk 12", 1, 48, 2, 64, 12, "model"),
    ("chunk 32", 1, 96, 1, 64, 32, "test"),
    ("chunk 32", 1, 128, 1, 64, 32, "model"),
    ("chunk 64", 1, 128, 1, 64, 64, "model"),
    ("chunk 64", 1, 128, 1, 64, 64, "test"),
    ("rwkv6-1.6b prefill, 16 heads of 128", 8, 512, 16, 128, 16, "model"),
    ("rwkv6-1.6b prefill, 8 heads of 256", 8, 512, 8, 256, 16, "model"),
    ("hd 100 chunk 24", 2, 240, 3, 100, 24, "test"),
    ("hd 72 chunk 12", 1, 96, 5, 72, 12, "model"),
    ("hd 200", 1, 64, 2, 200, 16, "clip"),
    ("hd 33 chunk 40", 2, 80, 2, 33, 40, "test"),
    ("hd 7 chunk 5", 1, 40, 3, 7, 5, "model"),
]
# and rwkv6-1.6b's widths with heads of 128 (16 heads), 2 layers in f32: a
# (batch, prompt) prefill and 4 greedy tokens, card against CPU
RWKV_WIDE = dict(rwkv_head_dim=128, layers=2, batch=2, prompt=512)
WKV_MAIN = 0            # the shape the RWKV-6 prefill gives the kernel
WKV_TURNS = (0, 1)      # the shapes timed at each split and with parents
# o and the final state, relative to max(1, max|ref|): the reference kernel
# test's atol (tests/test_kernels.py:104) at unit scale
WKV_TOL = 1e-4
RWKV_SERVE = ((8, 512), (1, 300))       # (batch, prompt tokens)
DENSE_GEN = 16          # tokens each dense-path request generates
# RWKV-6's f32 answer, card against CPU: logits and the WKV state within
# 1e-4 of their scale; x_tm and x_cm are stored in bf16, where a value
# near a rounding boundary may land one bf16 ulp (at most 2**-7 of it)
# apart.
RWKV_TOL = 1e-4
BF16_ULP = 2.0 ** -7
# phase 16: the seven collectives by tree on 8 ranks sharing the card
TREE_WORLD = 8
TREE_ROOTS = (0, 3, 7)
TREE_SMALL = 1 << 18        # f32 elements per rank: 1 MiB
TREE_GRID = (4, 2)          # pods x data of the torch backend: board pairs
# gpt-100m's 10 leaves in the reference's stacked layout: the embedding,
# the final norm, and over its 12 layers wq, wk, wv, wo, w1, w2 and the
# two norms
GPT_100M_LEAVES = [(32000, 768), (768,)] + [(12, 768, 768)] * 4 + [
    (12, 768, 3072), (12, 3072, 768), (12, 768), (12, 768)]
TREE_SEEDS = {"params": 1000, "grad": 2000, "x": 3000, "g": 4000,
              "sc": 5000, "ef": 6000}
# where gloo adds more than two terms in an order of its own, relative to
# max|ref|; every other result of the phase is held bit for bit
TREE_REL_TOL = 1e-6
# phase 17: phase 5's requests with the network plane on a 2x2x1 topology
SERVE_RUNS = ((8, 512), (1, 300))       # (requests, prompt tokens)
SERVE_GEN = 16
NET_MESH = "2x2x1"
# phase 18: phase 11's global batch, bucketed multilevel sync
BUCKET_TRAIN = dict(steps=3, seq=1024, batch=8, mesh_spec="2x2x1",
                    comm="multilevel", bucket_mb=25, dist_backend="gloo")
# phase 19: the bcast on the discovered topology
DISC_ROOT = 3
DISC_POLICY = "auto"        # plans on the measured levels
DISC_LOAD_S = 1.0           # loading the persisted topology, no probing
# phase 20: elastic training; 20a repairs in place, 20b restarts from a
# checkpoint below quorum, 20c holds the f32 losses through a failure to
# the CPU's (2 layers at full width, phase 12's rows and tolerance)
ELASTIC_REPAIR = dict(steps=6, seq=1024, batch=8, mesh_spec="4x1x1",
                      comm="multilevel_compress", zero1=True, ckpt_every=3,
                      fail_at={2: [1]})
ELASTIC_RESTART = dict(steps=8, seq=1024, batch=8, mesh_spec="2x2x1",
                       comm="multilevel", zero1=True, ckpt_every=3,
                       fail_at={7: [1]}, digests=True)
ELASTIC_ANSWER = dict(steps=4, seq=128, batch=4, mesh_spec="4x1x1",
                      comm="multilevel_compress", fail_at={2: [1]})
# losses: 20b replays step 7 from the checkpoint of step 6
ELASTIC_LOSSES = {"20a": 6, "20b": 8}
# 20a and 20b train gpt-100m at full width cut to 6 of its 12 layers (the
# whole script's 1200 s: phase 27 took the time)
ELASTIC_LAYERS = 6
# phase 21: olmoe-1b-7b at full width and depth through the paged
# scheduler, phase 5's requests; then one profiled prefill of 8 x 512
MOE_ARCH = "olmoe-1b-7b"
MOE_PROFILE = (8, 512)
# phase 22: (arch, layers kept or None for all, (batch, prompt tokens) of
# each prefill, prefix positions: patch embeds or encoder frames)
DENSE_SERVE = [
    ("recurrentgemma-2b", None, ((4, 512), (1, 2048)), 0),
    ("seamless-m4t-medium", None, ((4, 128),), 512),
    ("pixtral-12b", None, ((4, 256),), 256),
    ("llama4-scout-17b-a16e", 4, ((4, 512),), 0),
]
# phase 23: f32, card against CPU, one pattern period of each config at
# full width: its layers (encoder and decoder each for enc-dec), then a
# batch of 2 prompts of 48 tokens after 32 prefix positions where the
# config takes them, and 4 decode steps.  Logits and f32 cache leaves
# within 1e-4 of their scale; bf16 cache leaves within one bf16 ulp (as
# phase 15).  A token whose top-k experts differ between card and CPU is a
# near-tie only if its k-th and (k+1)-th probabilities on the CPU are
# within 1e-6, else a failure; near-ties are counted and printed.
ANSWER_LAYERS = {"llama4-scout-17b-a16e": 2, "olmoe-1b-7b": 2,
                 "recurrentgemma-2b": 3, "seamless-m4t-medium": 2,
                 "pixtral-12b": 2}
ANSWER_INPUT = (2, 48, 32)       # batch, prompt tokens, prefix positions
ANSWER_STEPS = 4
ARCH_TOL = 1e-4
NEAR_TIE = 1e-6
# phase 24: serving on a model axis, the M ranks of one model group
# sharing the card over gloo (staged through host memory).  24a gpt-100m
# through serve on each mesh (M 4 through serve is 24b's: olmoe's
# attention on 4 heads a rank, the same path; gpt-100m at M 4 is 24d's)
# and 24b olmoe-1b-7b (16 experts a rank, its capacity_factor 1.25),
# phase 5's batch; 24c the dense path on
# gemma3-12b cut to its first pattern period (5 windowed layers, 1
# global), caches sized to a multiple of 8 so the model axis divides them
# (the sequence-parallel decode); the 2048-token prompt wraps the
# 1024-slot ring; 24d the three configs at their smoke configs' depth and
# full width in f32, each model group against the one-rank model
TP_SERVE = ("1x1x2",)
TP_MOE_MESH = "1x1x4"
# each ``serve`` call on a model axis spawns its ranks: one call each, the
# batch of SERVE_RUNS (the one-request run is phase 5's and 21's alone)
TP_SERVE_RUNS = SERVE_RUNS[:1]
TP_DENSE = ("gemma3-12b", 6, "1x1x2", ((4, 512), (1, 2048)))
TP_ANSWER = {2: ("gpt-100m", "gemma3-12b"), 4: ("gpt-100m", "olmoe-1b-7b")}
TP_ANSWER_INPUT = (2, 48, 8)    # dense batch, prompt, the paged prompt's pad
TP_ANSWER_STEPS = 4
TP_ANSWER_BLOCK = 8     # the paged pools' block size
# bf16 first-prefill logits against the one-rank run's: the tests' bf16
# LOGIT_TOL (tests/test_torch_model.py:38); the row-parallel sums round
# in another order
LOGIT_TOL = 5e-2
# f32: the prefills' logits against the one-rank model's; a decode step
# (from the one-rank cache) also reads the k and v it writes to bf16,
# which may round to the neighbouring value (tests/test_torch_tp.py)
TP_F32_TOL = 1e-5
TP_STEP_TOL = 1e-4
# phase 25: training on a model axis.  25a and 25b at full width and depth
# (4 rows a data-parallel rank), 25c gpt-100m's 2 layers in f32, 25d
# qwen3-4b cut to 4 layers in bf16
TP_TRAIN = {"25a": dict(steps=4, seq=1024, batch=8, mesh_spec="1x2x2",
                        comm="multilevel", dist_backend="gloo"),
            "25b": dict(steps=4, seq=1024, batch=8, mesh_spec="2x1x2",
                        comm="multilevel_compress", dist_backend="gloo")}
TP_TRAIN_ANSWER = dict(steps=2, seq=128, batch=4)
# (pods, data, model) grids of 25c and the devices each runs on
TP_TRAIN_GRIDS = {2: (((1, 1, 2), ("cuda", "cpu")), ((2, 1, 1), ("cuda",))),
                  4: (((2, 1, 2), ("cuda", "cpu")),)}
TP_TRAIN_TOL = 1e-4     # relative, tests/test_torch_train.py's trajectory
TP_QWEN = ("qwen3-4b", 4, "1x1x2", dict(steps=2, seq=1024, batch=2))
# bf16: the first step's loss (before any update) of the model group
# against one rank: tests/test_torch_train.py's bf16 loss tolerance
TP_QWEN_TOL = 1e-2


# phase 26: training the MoE, RG-LRU, enc-dec and frontend configs on one
# rank.  26a-26d bf16 through ``train``: (arch, layers kept or None for
# all, steps, sequence, batch); 26a is the full-width path
FAMILY_TRAIN = {
    "26a": ("recurrentgemma-2b", None, dict(steps=3, seq=4096, batch=1)),
    "26b": ("seamless-m4t-medium", None, dict(steps=2, seq=1024, batch=4)),
    "26c": ("olmoe-1b-7b", 4, dict(steps=2, seq=1024, batch=2)),
    "26d": ("pixtral-12b", 4, dict(steps=2, seq=1024, batch=2)),
}
# 26e: f32, card against CPU, the training step's loss and gradient
# (``step.loss_and_grads``, the forward, the remat's re-run and the
# backward that ``make_train_step`` runs) at full width (arch, layers
# kept, or None for the smoke config): the loss within 1e-5 relative, and
# every gradient leaf of the stacked layout within 1e-4 of its largest
# |g| on the CPU, the CPU tests' f32 gradient tolerance
# (tests/test_torch_train.py).  Adam's first moment after the step is
# 0.1 x the clipped gradient, so this holds what it held, without the
# CPU's AdamW over every parameter, which took most of the phase
FAMILY_ANSWER = [("recurrentgemma-2b", 3), ("olmoe-1b-7b", 1),
                 ("pixtral-12b", 1), ("seamless-m4t-medium", 1),
                 ("llama4-scout-17b-a16e", None)]
FAMILY_ANSWER_INPUT = dict(seq=256, batch=1)
FAMILY_LOSS_TOL = 1e-5
FAMILY_G_TOL = 1e-4
# llama4-scout routes each token to one expert, whose renormalised gate is
# 1: its router's gradient is zero but for rounding, held on each side
# under 1e-6 of the largest |g| (as tests/test_torch_train.py holds it)
FAMILY_ZERO_TOL = 1e-6
# 26f: olmoe-1b-7b at full width cut to 1 layer, f32, on 2x2x1 ranks
# sharing the card over gloo against one rank on the card
FAMILY_GRID = ("olmoe-1b-7b", 1, dict(steps=2, seq=256, batch=4))
FAMILY_GRID_TOL = 1e-4     # relative, tests/test_torch_train.py's grid
# phase 27: training RWKV-6 on one rank (27a bf16 at full width and
# depth through ``train``, at the serving prefill's shape; 27b f32 card
# against CPU at 2 layers, 26e's tolerances), and the MoE and the frontend
# on a model axis (27c olmoe-1b-7b at 4 of 16 layers on 1x1x2 in bf16, so
# that its step compares with 26c's one rank; 27d olmoe and pixtral at 1
# layer in f32 on 1x1x2 against one rank on the card, unclipped, the
# MoE's capacity factor at the axis size so that no slot drops)
RWKV_TRAIN = dict(steps=3, seq=512, batch=8)
RWKV_TRAIN_ANSWER = ("rwkv6-1.6b", 2)
TP_MOE_TRAIN = ("olmoe-1b-7b", 4, dict(steps=2, seq=1024, batch=2,
                                       mesh_spec="1x1x2"))
TP_FAMILY_ANSWER = [("olmoe-1b-7b", 1), ("pixtral-12b", 1)]
TP_FAMILY_ANSWER_INPUT = dict(seq=256, batch=2, model=2)
TP_FAMILY_TOL = 1e-4     # the loss relative, m of each leaf's largest
# phase 28: RWKV-6 and the enc-dec config on a model axis, the ranks of
# TP_RS_MESH sharing the card over gloo.  28a-b serve at full width and
# depth through make_prefill_fn/make_decode_fn: (arch, batch, prompt
# tokens, encoder frames), TP_RS_GEN greedy tokens (the prefill's and 8
# decode steps'), the first prefill's bf16 logits no farther from the
# one-rank f32 model's than the one-rank bf16 run's, plus LOGIT_TOL (the
# full-depth bf16 models' largest logits, 17.8 and 24.4, sit where a bf16
# ulp is 0.125: their own rounding moves them by more than LOGIT_TOL,
# PERF.md section 6); 28c trains in bf16 (arch, layers kept),
# TP_RS_TRAIN_KW; 28d f32 at full width cut to (arch, layers) against one
# rank on the card: the dense prefill's logits within TP_F32_TOL, 4
# decode steps from the one-rank cache within TP_STEP_TOL (RWKV-6's
# carried rows are bf16, as the k and v of a cache), one unclipped
# training step's loss and Adam's m within TP_FAMILY_TOL.  Phase 29: the
# RG-LRU family and the KV-head split on the same ranks, recurrentgemma-2b
# served whole (29a, its tokens also equal to one rank's), trained at 3
# layers (29b: one whole period, its RG-LRU run on the run dim) and held
# in f32 at 3 (29c, its decode steps within TP_F32_TOL)
TP_RS_MESH = "1x1x2"
TP_RS_SERVE = {"28a": ("rwkv6-1.6b", 2, 512, 0),
               "28b": ("seamless-m4t-medium", 2, 512, 512),
               "29a": ("recurrentgemma-2b", 2, 512, 0)}
# tokens held to the one-rank run's too
TP_RS_SAME_TOKENS = {"29a", "31a", "33a", "33c", "33d", "33e"}
TP_RS_GEN = 9
# arch -> (layers kept, phase)
TP_RS_TRAIN = {"rwkv6-1.6b": (4, "28c"), "seamless-m4t-medium": (12, "28c"),
               "recurrentgemma-2b": (3, "29b")}
TP_RS_TRAIN_KW = dict(steps=3, seq=512, batch=2)
# (arch, layers, phase, the decode steps' tolerance)
TP_RS_ANSWER = [("rwkv6-1.6b", 2, "28d", TP_STEP_TOL),
                ("seamless-m4t-medium", 1, "28d", TP_STEP_TOL),
                ("recurrentgemma-2b", 3, "29c", TP_F32_TOL)]
TP_RS_ANSWER_INPUT = (2, 48, 32)    # batch, prompt, encoder frames
# phase 31: a model axis of 4 that cuts recurrentgemma-2b's heads (640
# query columns a rank) and leaves seamless-m4t-medium's 256,206-row
# vocabulary replicated, on phase 10's four ranks: 31a serves 29a's model
# and input (held to 29a's one-rank run; its bf16 bound takes one bf16
# step of the largest logit, and its f32 prefill is held to one rank's:
# PERF.md section 6), 31b trains as 29b, 31c-d hold f32 as 29c and 28d
# (arch, layers, phase, the decode steps' tolerance)
HEADCUT_MESH = "1x1x4"
HEADCUT_SERVE = TP_RS_SERVE["29a"]
HEADCUT_TRAIN = {"recurrentgemma-2b": (3, "31b")}
# 31b's steps and 31a's tokens (held to the first of 29a's): 3 and 9
# until whole runs passed 1000 s (PERF.md section 6)
HEADCUT_TRAIN_KW = dict(TP_RS_TRAIN_KW, steps=2)
# phase 32: the dry runs of phase 7's and 26a's and 27a's training steps,
# and the band phase 7's peak must hold the dry run's bytes in
DRY_TRAIN = {"7": ("gpt-100m", None, TRAIN),
             "26a": FAMILY_TRAIN["26a"],
             "27a": ("rwkv6-1.6b", None, RWKV_TRAIN)}
DRY_MEM_RATIO = (0.85, 1.15)
HEADCUT_GEN = 5
HEADCUT_ANSWER = [("recurrentgemma-2b", 3, "31c", TP_F32_TOL),
                  ("seamless-m4t-medium", 1, "31d", TP_STEP_TOL)]
# phase 33: a model axis of 3, which the reference's fallbacks meet by
# moving a leaf to its other matmul dim or replicating it, on members 0-2
# of phase 10's four ranks (rank 3 leaves): 33a serves phi4-mini-3.8b
# whole (MLP wi/wg by rows and wo by columns, wk/wv by rows), 33b trains
# it at 3 layers (bf16) and holds it in f32 to one rank, 33c serves
# gemma3-12b at 6 layers (wq/wk/wv by rows, wo by columns, the embedding
# whole), 33d olmoe-1b-7b at 4 (attention and the 64 experts whole: the
# dense block), 33e rwkv6-1.6b at 4 (every leaf whole).  Each served
# phase's tokens equal one rank's, its bf16 logits held as 31a's, and
# (33a, 33c) the f32 prefill of the same weights within TP_F32_TOL of one
# rank's; the caches are sized to a multiple of 24, which M 3 divides:
# the sequence-parallel decode
FALLBACK_MESH = "1x1x3"
FALLBACK_MEMBERS = [0, 1, 2]
# phase -> (arch, layers kept, batch, prompt)
FALLBACK_SERVE = {"33a": ("phi4-mini-3.8b", None, 2, 512),
                  "33c": ("gemma3-12b", 6, 2, 512),
                  "33d": ("olmoe-1b-7b", 4, 2, 512),
                  "33e": ("rwkv6-1.6b", 4, 2, 512)}
FALLBACK_F32 = {"33a", "33c"}
FALLBACK_ALIGN = 24
FALLBACK_TRAIN = {"phi4-mini-3.8b": (3, "33b")}
FALLBACK_TRAIN_KW = dict(TP_RS_TRAIN_KW, steps=2)
FALLBACK_ANSWER = [("phi4-mini-3.8b", 3, "33b", TP_STEP_TOL)]
# phase 34: the cuts inside a unit, llama4-scout-17b-a16e on a model axis
# of 32 (its 16 experts' 8192 features cut, 256 a rank, w_out by the 160
# columns of its output; 2 or 3 of the 40 query heads, one cut inside, on
# 1-2 of the 8 KV heads) on 32 ranks forked for it; the weights drawn
# part by part (``drawn_params``) so that a rank draws only its shard.
# 34a serves INSIDE_LAYERS of its 48 layers, a 1 x 512 prompt and
# INSIDE_GEN new tokens on the dense and the paged path; 34b trains one
# layer in f32 at 1 x 256; 34c holds the WKV kernel at a rank of
# rwkv6-1.6b on M 64 (the one head of 64 its 32 columns meet)
INSIDE_ARCH = "llama4-scout-17b-a16e"
INSIDE_MODEL = 32
INSIDE_LAYERS = 2
INSIDE_PROMPT = (1, 512)
INSIDE_GEN = 4
INSIDE_BLOCK = 16               # the paged pools' block size
INSIDE_SEED = 34
INSIDE_TRAIN = (1, (1, 256))    # 34b: layers, (batch, seq)
INSIDE_SAMPLE = 128             # 34b: rows of each expert compared
# the collectives of each call, predicted from the code (n layers): the
# embedding's sum; a layer's q and k/v gathers (gather_to: 40 heads and 8
# KV heads on 32 ranks), wo's partial sum, the experts' hidden gathered
# and the combine's columns (gather_from), the shared MLP's partial sum;
# the dense prefill's two gathers of k and v into the sequence split;
# the decode's sequence-parallel combine (a max and two sums); the
# logits' gather.  34b's forward adds the vocab-parallel loss's max and
# sums; its backward holds a copy_to sum each (the attention's input,
# the MoE's input, its gates and its routed rows, the loss's hidden) and
# a reduce-scatter each gather_to; the remat re-runs the layer to the
# last tensor the backward saved: all but the shared MLP's sum
INSIDE_CALLS = {"dense_prefill": lambda n: 1 + 6 * n + 2 + 1,
                "dense_step": lambda n: 1 + 9 * n + 1,
                "paged_prefill": lambda n: 1 + 6 * n + 1,
                "paged_step": lambda n: 1 + 6 * n + 1,
                "train": lambda n: {"fwd": 1 + 6 * n + 2,
                                    "bwd": 4 * n + 1 + 3 * n,
                                    "remat": 5 * n}}
INSIDE_WKV = ("rwkv6-1.6b rank of M 64", 2, 512, 1, 64, "model")
# phase 30: elastic training on a model axis, gpt-100m at full width cut
# to TP_ELASTIC_LAYERS layers: pod 1 of 3 lost before step 2 (an in-place
# repair), pod 1 of the 2 left before step 4 (a restart from step 2's
# checkpoint with accum 2); the reference's 3x1x1 decisions
# (tests/test_torch_tp_elastic.py): the events as (event, in_place or
# survivors), the counts, the final grid, the saves as (step, pods).
# seq 256: at 512 the whole script passed 1000 s (1012 s)
TP_ELASTIC = dict(steps=6, seq=256, batch=6, mesh_spec="3x1x2",
                  comm="multilevel_compress", zero1=True, ckpt_every=2,
                  fail_at={2: [1], 4: [1]}, digests=True,
                  dist_backend="gloo")
TP_ELASTIC_LAYERS = 2
TP_ELASTIC_EVENTS = [("failure", True), ("repair", 2), ("failure", False)]
TP_ELASTIC_WANT = {"repairs": 1, "recoveries": 1, "accum": 2, "pods": 1,
                   "world": 1, "model": 2}
TP_ELASTIC_SAVES = [(2, 2), (4, 1)]
# steps 0-3 run once each (3 pods, then 2: a slow axis); the restart
# replays steps 3-5 on one pod, 2 micro-steps each
TP_ELASTIC_MICRO, TP_ELASTIC_SLOW = 4 + 3 * 2, 4


def progress(phase: str, t0: float) -> None:
    """Print the script's elapsed seconds as ``phase`` starts, so that a
    run cut by its time limit still shows where its time went."""
    print(json.dumps({"starting_phase": phase,
                      "elapsed_s": time.perf_counter() - t0}), flush=True)


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


def mask_of(torch, shape):
    """The (Sq, Sk) keep-mask of a shape, on the card."""
    _, B, Sq, Sk, H, Hkv, hd, causal, window, q_offset, dt = shape
    qpos = q_offset + torch.arange(Sq, device="cuda")[:, None]
    kpos = torch.arange(Sk, device="cuda")[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def sdpa_of(torch, shape, mask):
    """One SDPA call on (B,S,H,hd) inputs: the library yardstick."""
    _, B, Sq, Sk, H, Hkv, hd, causal, window, q_offset, dt = shape
    plain_causal = causal and window is None and q_offset == 0 and Sq == Sk
    unmasked = not causal and window is None
    return lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=None if plain_causal or unmasked else mask,
        is_causal=plain_causal, enable_gqa=Hkv != H)


def inputs_of(torch, shape, seed=0):
    """q, k, v and a cotangent do on the card, from a seeded generator."""
    _, B, Sq, Sk, H, Hkv, hd, causal, window, q_offset, dt = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda").to(getattr(torch, dt))
            for s in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd),
                      (B, Sq, H, hd))]


ACHIEVED = []       # (hw name, achieved_flops_frac, achieved_bw_frac)


def bound(flops, nbytes, dt, rec) -> None:
    """Writes into ``rec``, a kernel's record with its ``kernel_ms``, the
    bound of ``flops`` and ``nbytes`` on the card's datasheet ceilings for
    ``dt`` (``costmodel.kernel_roofline``: ``bound_ms``, ``bound_by``) and
    the fractions of the peaks that time achieved."""
    from repro_torch.core.costmodel import H100, H100_F32, kernel_roofline

    hw = H100 if dt == "bfloat16" else H100_F32
    r = kernel_roofline(flops, nbytes, hw=hw, wall_s=rec["kernel_ms"] / 1e3)
    rec.update(bound_ms=r["model_s"] * 1e3,
               bound_by="operations" if r["bound"] == "compute" else "bytes",
               achieved_flops_frac=r["achieved_flops_frac"],
               achieved_bw_frac=r["achieved_bw_frac"])
    ACHIEVED.append((hw.name, r["achieved_flops_frac"],
                     r["achieved_bw_frac"]))


def refit_phase() -> None:
    """After phases 3, 4, 9 and 13: the best fractions of the peaks the
    kernels achieved, bf16 FLOPs on the tensor cores and HBM bytes, and the
    ``costmodel.refit_hw`` H100 they give."""
    from repro_torch.core.costmodel import H100, refit_hw

    flops = max(f for hw, f, _ in ACHIEVED if hw == H100.name)
    bw = max(b for _, _, b in ACHIEVED)
    fit = refit_hw(H100, flops_frac=flops, bw_frac=bw, name="h100_fit")
    print(json.dumps({"refit_hw": {
        "best_achieved_flops_frac_bf16": flops,
        "best_achieved_bw_frac": bw, "hw": dataclasses.asdict(fit)}}),
        flush=True)


def fwd_check(torch, fa, shape, q, k, v) -> tuple[float, dict]:
    """The forward kernel against its plain version (``TOL``) and, in
    bf16, its mirror (``MIRROR_TOL``, ``LSE_MIRROR_TOL``); fails past
    them.  Returns the max abs error and the errors over max|mirror|."""
    name, B, Sq, Sk, H, Hkv, hd, causal, window, q_offset, dt = shape
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, **kw)
    err = max((o.float() - o_ref.float()).abs().max().item(),
              (lse - lse_ref).abs().max().item())
    if not (torch.isfinite(o.float()).all() and err <= TOL[dt]):
        fail(f"flash_fwd {name} {dt}: max abs err {err} > {TOL[dt]}")
    mirror = {}
    if dt == "bfloat16":
        o_m, lse_m = fa.flash_attention_fwd_bf16_ref(q, k, v, **kw)
        top = o_m.abs().max().item()
        lse_top = max(1.0, lse_m.abs().max().item())
        mirror = {"o": (o.float() - o_m).abs().max().item() / top,
                  "lse": (lse - lse_m).abs().max().item() / lse_top}
        if not (mirror["o"] <= MIRROR_TOL
                and mirror["lse"] <= LSE_MIRROR_TOL):
            fail(f"flash_fwd {name} {dt} against the mirror: err over "
                 f"max|mirror| {mirror}, limits o {MIRROR_TOL} lse "
                 f"{LSE_MIRROR_TOL}")
    return err, mirror


def flash_phase(torch, fa, shape) -> dict:
    name, B, Sq, Sk, H, Hkv, hd, causal, window, q_offset, dt = shape
    q, k, v, _ = inputs_of(torch, shape)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    err, mirror = fwd_check(torch, fa, shape, q, k, v)

    mask = mask_of(torch, shape)
    sdpa = sdpa_of(torch, shape, mask)
    # the work this run's inputs need: unmasked (q, k) pairs, two products
    flops, nbytes = fa.fwd_work(B, Sq, Sk, H, Hkv, hd, **kw,
                                esz=q.element_size())
    run = lambda: fa.flash_attention_fwd(q, k, v, **kw)
    lib = lambda: sdpa(q, k, v)
    turns = [cuda_ms(torch, run, 20), cuda_ms(torch, lib, 20),
             cuda_ms(torch, lib, 20), cuda_ms(torch, run, 20)]
    rec = {
        "shape": name, "B": B, "Sq": Sq, "Sk": Sk, "H": H, "Hkv": Hkv,
        "hd": hd, "width": fa.kernel_width(hd),
        "padding_share": fa.kernel_width(hd) / hd - 1, "causal": causal,
        "window": window, "q_offset": q_offset,
        "dtype": dt, "design": "mma_bf16" if dt == "bfloat16" else "fma_f32",
        "max_abs_err": err, "err_over_max_mirror": mirror,
        "kernel_ms": (turns[0] + turns[3]) / 2,
        "kernel_ms_turns": [turns[0], turns[3]],
        "plain_ms": cuda_ms(torch, lambda: fa.flash_attention_fwd_ref(
            q, k, v, **kw), 3),
        "library_ms": (turns[1] + turns[2]) / 2,
        "library_ms_turns": turns[1:3],
    }
    if dt == "bfloat16":      # at 1 x 512 the events time the host
        rec["kernel_device_ms"] = device_time(torch, run)[0]
        rec["library_device_ms"], rec["library_kernels"] = \
            device_time(torch, lib)
    rec["kernel_tflops"] = flops / rec["kernel_ms"] / 1e9
    bound(flops, nbytes, dt, rec)
    print(json.dumps({"flash_fwd": rec}), flush=True)
    return rec


def bwd_check(torch, fa, shape, q, k, v, do):
    """The dq and dk/dv kernels against their plain versions (``BWD_TOL``
    of max|ref|) and, in bf16, their mirrors (``MIRROR_TOL``), on the same
    (q, k, v, do, lse, delta); fails past them.  Returns the errors, the
    errors over max|ref|, the tolerances, lse and delta."""
    name, B, Sq, Sk, H, Hkv, hd, causal, window, q_offset, dt = shape
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    delta = fa._delta(o, do, lse)
    refs = {"f32": (fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw),
                    *fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw))}
    tols = {"f32": BWD_TOL[dt]}
    if dt == "bfloat16":
        refs["mirror"] = (
            fa.flash_bwd_dq_bf16_ref(q, k, v, do, lse, delta, **kw),
            *fa.flash_bwd_dkv_bf16_ref(q, k, v, do, lse, delta, **kw))
        tols["mirror"] = MIRROR_TOL
    errs, rel = {}, {}
    for ref, want in refs.items():
        for g, w, what in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
            err = (g.float() - w.float()).abs().max().item()
            top = w.float().abs().max().item()
            ok = torch.isfinite(g.float()).all() and err <= tols[ref] * top
            if not ok:
                fail(f"flash bwd {what} {name} {dt} against the {ref} plain "
                     f"version: max abs err {err} > {tols[ref]} x {top}")
            errs.setdefault(ref, {})[what] = err
            rel.setdefault(ref, {})[what] = err / top
    return errs, rel, tols, lse, delta


def flash_bwd_phase(torch, fa, shape) -> dict:
    """dq and dk/dv kernels against their plain versions on the same
    (q, k, v, do, lse, delta); one record per kernel."""
    name, B, Sq, Sk, H, Hkv, hd, causal, window, q_offset, dt = shape
    q, k, v, do = inputs_of(torch, shape)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    errs, rel, tols, lse, delta = bwd_check(torch, fa, shape, q, k, v, do)

    # SDPA's backward on its own: one forward, then the gradient over the
    # retained graph, timed in turns with each kernel
    mask = mask_of(torch, shape)
    sdpa = sdpa_of(torch, shape, mask)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    sdpa_out = sdpa(*leaves)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, leaves, dot,
                                           retain_graph=True)
    sdpa_device_ms, sdpa_kernels = device_time(torch, sdpa_bwd)

    dims = (B, Sq, Sk, H, Hkv, hd)
    out = {}
    for kern, (flops, nbytes), run, plain, what in (
            ("flash_bwd_dq", fa.bwd_dq_work(*dims, **kw,
                                            esz=q.element_size()),
             lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw),
             ("dq",)),
            ("flash_bwd_dkv", fa.bwd_dkv_work(*dims, **kw,
                                              esz=q.element_size()),
             lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
             lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw),
             ("dk", "dv"))):
        turns = [cuda_ms(torch, run, 20), cuda_ms(torch, sdpa_bwd, 20),
                 cuda_ms(torch, sdpa_bwd, 20), cuda_ms(torch, run, 20)]
        rec = {"shape": name, "B": B, "Sq": Sq, "Sk": Sk, "H": H,
               "Hkv": Hkv, "hd": hd, "width": fa.kernel_width(hd),
               "padding_share": fa.kernel_width(hd) / hd - 1,
               "causal": causal, "window": window,
               "q_offset": q_offset, "dtype": dt,
               "design": "mma_bf16" if dt == "bfloat16" else "fma_f32",
               "max_abs_err": max(errs["f32"][w] for w in what),
               "max_abs_err_dq_dk_dv": errs,
               "err_over_max_ref_dq_dk_dv": rel, "tolerances": tols,
               "kernel_ms": (turns[0] + turns[3]) / 2,
               "kernel_ms_turns": [turns[0], turns[3]],
               "kernel_device_ms": device_time(torch, run)[0],
               "plain_ms": cuda_ms(torch, plain, 3),
               "library_ms": (turns[1] + turns[2]) / 2,
               "library_ms_turns": turns[1:3],
               "library_device_ms": sdpa_device_ms,
               "library_kernels": sdpa_kernels}
        rec["kernel_tflops"] = flops / rec["kernel_ms"] / 1e9
        bound(flops, nbytes, dt, rec)
        print(json.dumps({kern: rec}), flush=True)
        out[kern] = rec
    return out


def width_phase(torch, fa, kw, L) -> dict:
    """35: the three flash kernels at head dims between their tile widths
    (``WIDTH_SHAPES``, bf16 and f32) against their plain versions and
    mirrors; ``layers.chunked_attention`` forward and backward through
    autograd at phi-3-mini's shape, its launches counted; the two timed
    shapes.  Returns the launches of the autograd run."""
    t0 = time.perf_counter()
    checks = {}
    for shape in WIDTH_SHAPES:
        for dt in ("bfloat16", "float32"):
            s = (*shape, dt)
            q, k, v, do = inputs_of(torch, s)
            err, mirror = fwd_check(torch, fa, s, q, k, v)
            errs, rel, _, _, _ = bwd_check(torch, fa, s, q, k, v, do)
            checks[f"{shape[0]} {dt}"] = {
                "width": fa.kernel_width(shape[6]), "fwd_max_abs_err": err,
                "fwd_err_over_max_mirror": mirror,
                "bwd_err_over_max_ref": rel}

    # the model's attention at hd 96: forward and backward by autograd
    shape = WIDTH_TIMED[0]
    q, k, v, do = inputs_of(torch, shape)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    reset(fa, kw)
    o = L.chunked_attention(*leaves, causal=True)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    launched = counts(fa, kw)
    want = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1, "wkv": 0}
    if launched != want:
        fail(f"phase 35: chunked_attention at hd 96 launched {launched}, "
             f"expected {want}")
    o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, causal=True)
    auto = {"o": (o.float() - o_ref.float()).abs().max().item()}
    if not auto["o"] <= TOL["bfloat16"]:
        fail(f"phase 35: chunked_attention's o at hd 96 {auto['o']} from "
             f"the plain version, tolerance {TOL['bfloat16']}")
    for g, w, what in zip(grads, fa.flash_attention_bwd_ref(
            q, k, v, o.detach(), lse_ref, do, causal=True),
            ("dq", "dk", "dv")):
        top = w.float().abs().max().item()
        auto[what] = (g.float() - w.float()).abs().max().item() / top
        if not (torch.isfinite(g.float()).all()
                and auto[what] <= BWD_TOL["bfloat16"]):
            fail(f"phase 35: chunked_attention's {what} at hd 96 "
                 f"{auto[what]} of max|ref| from the plain version, "
                 f"tolerance {BWD_TOL['bfloat16']}")
    del o, grads, leaves

    timed = {}
    for shape in WIDTH_TIMED:
        f = flash_phase(torch, fa, shape)
        b = flash_bwd_phase(torch, fa, shape)
        timed[shape[0]] = {
            kern: {x: r[x] for x in (
                "hd", "width", "padding_share", "kernel_ms",
                "kernel_device_ms", "bound_ms", "bound_by", "library_ms",
                "library_device_ms", "plain_ms")}
            for kern, r in (("flash_fwd", f), *b.items())}
    print(json.dumps({"phase_35": {
        "checks": checks, "chunked_attention_hd96": {
            "launches": launched, "err_o": auto["o"],
            "err_over_max_ref": {w: auto[w] for w in ("dq", "dk", "dv")}},
        "timed": timed, "wall_s": time.perf_counter() - t0}}), flush=True)
    return launched


def device_time(torch, fn, reps: int = 10) -> tuple[float, list]:
    """The card's ms per call of ``fn``, summed over the kernels it runs,
    and their names (cut to 100 characters), from torch.profiler: what a
    library call costs the card where its host side, not the card, paces
    a run of calls, and which backend it took."""
    fn()
    torch.cuda.synchronize()
    P = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[P.CPU, P.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kerns = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kerns) / 1e3 / reps,
            sorted({e.key[:100] for e in kerns}))


def tensor_core_ops(sass: str) -> dict:
    """HMMA/HGMMA instructions in the SASS of each flash kernel, by kernel,
    tile width and instance (``exact``: hd equal to the width; ``padded``:
    below it), from ``cuobjdump -sass``."""
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_bf16)?)"
                          r"_kernelILi(\d+)ELb([01])E", line)
            cur = m and (f"{m.group(1)} hd {m.group(2)} "
                         f"{'exact' if m.group(3) == '1' else 'padded'}")
            if cur:
                counts[cur] = 0
        elif cur and re.search(r"\bHG?MMA\b", line):
            counts[cur] += 1
    return counts


def reset(fa, kw) -> None:
    for f in (fa.flash_attention_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
              kw.wkv_chunked):
        f.launches = 0


def counts(fa, kw) -> dict:
    return {"flash_fwd": fa.flash_attention_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
            "wkv": kw.wkv_chunked.launches}


def train_answer(torch, get_config) -> None:
    """gpt-100m at full width, 2 layers, f32: 3 steps and one gradient on
    the card against the CPU."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.step import (device_batch, loss_and_grads,
                                         make_train_step)
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import stack_runs
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("gpt-100m"), n_layers=2,
                              pattern=("attn",) * 2)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=3)
    pipe = DataPipeline(cfg, ShapeSpec("answer", "train", 512, 2))
    p_cpu = tree_map(lambda t: t.float(),
                     T.init_model(cfg, seed=0, device="cpu"))
    runs = {}
    for dev in ("cuda", "cpu"):
        layers = tree_map(lambda t: t.to(dev), p_cpu)
        _, grads = loss_and_grads(layers, cfg,
                                  device_batch(pipe.host_batch(0), dev))
        wq = grads["layers"][0]["attn"]["wq"].cpu()
        params = stack_runs(layers, cfg)
        opt = init_opt_state(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg, device=dev)
        losses = []
        for i in range(3):
            params, opt, loss = step(params, opt, pipe.host_batch(i))
            losses.append(loss.item())
        runs[dev] = (losses, wq)
    (l_gpu, g_gpu), (l_cpu, g_cpu) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    g_err = (g_gpu - g_cpu).abs().max().item()
    g_max = g_cpu.abs().max().item()
    print(json.dumps({"train_f32_card_vs_cpu": {
        "losses_card": l_gpu, "losses_cpu": l_cpu, "max_rel_loss_diff": rel,
        "wq_grad_max_abs_diff": g_err, "wq_grad_max_abs": g_max}}),
        flush=True)
    if not math.isfinite(rel) or rel > 1e-4:
        fail(f"f32 training losses differ by {rel} (relative) between card "
             f"and CPU")
    if not math.isfinite(g_err) or g_err > 1e-3 * g_max:
        fail(f"f32 wq gradient differs by {g_err} between card and CPU "
             f"(max |g| {g_max})")


def same(torch, a, b) -> bool:
    """Bit for bit, with NaN where NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32))


def quant_check(torch, kq, C, name, x, ef) -> dict:
    """The three int8 kernels against their plain versions on the same
    inputs; any bit that differs fails the run.  Returns each kernel's
    largest absolute difference over its finite outputs (0 when every bit
    agrees)."""
    n = x.numel()
    xp, _ = C.pad_to_block(x, C.QTILE)
    efp, _ = C.pad_to_block(ef, C.QTILE)
    q, s, pad = kq.quantize_int8(x)
    qr, sr = kq.quantize_int8_ref(xp)
    d = kq.dequantize_int8(q, s, pad)
    dr = kq.dequantize_int8_ref(q, s)[:n]
    qe, se, re, _ = kq.quantize_ef_int8(x, ef)
    qer, ser, rer = kq.quantize_ef_int8_ref(xp, efp)
    torch.cuda.synchronize()
    pairs = {"quantize_int8": ((q, qr), (s, sr)),
             "dequantize_int8": ((d, dr),),
             "quantize_ef_int8": ((qe, qer), (se, ser), (re, rer[:n]))}
    err = {}
    for kern, outs in pairs.items():
        for a, b in outs:
            if not same(torch, a, b):
                fail(f"{kern} differs from its plain version ({name}, "
                     f"n={n})")
        err[kern] = max(torch.nan_to_num((a.float() - b.float()).abs(),
                                         nan=0.0).max().item()
                        for a, b in outs)
    return err


def quant_phase(torch) -> dict:
    """Kernels #4-#6 against their plain versions, bit for bit, at edge
    cases and at the main-path size; times there."""
    from repro_torch.core import compression as C
    from repro_torch.kernels import quant as kq

    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda n, sd=1.0: sd * torch.randn(n, generator=gen,
                                               device="cuda")

    def make(n):
        x = randn(n, 3.0)
        if n >= 512:             # scale exactly 1, values k + 0.5: ties
            x[256:512] = torch.arange(256, device="cuda") % 20 - 9.5
            x[256] = 127.0
        if n >= 768:
            x[512:768] = 0.0     # scale 1e-12, q 0
        return x

    cases = {f"n={n}": make(n) for n in (256, C.QTILE, 3 * C.QTILE - 100,
                                         333)}
    cases["nan"] = make(1024)
    cases["nan"][300] = float("nan")
    cases["f32max"] = make(1024)
    cases["f32max"][0], cases["f32max"][600] = C.F32_MAX, -C.F32_MAX
    cases["inf"] = make(1024)
    cases["inf"][700] = float("inf")
    for name, x in cases.items():
        quant_check(torch, kq, C, name, x, randn(x.numel(), 0.05))
    r = cases["f32max"]
    _, _, res, _ = kq.quantize_ef_int8(r, torch.zeros_like(r))
    if not torch.isfinite(res[:768]).all():
        fail("quantize_ef_int8 residual overflowed at F32_MAX")

    x, ef = randn(QUANT_MAIN_N), randn(QUANT_MAIN_N, 0.01)
    err = quant_check(torch, kq, C, "main path", x, ef)
    xp, _ = C.pad_to_block(x, C.QTILE)       # time the kernels alone
    efp, _ = C.pad_to_block(ef, C.QTILE)
    q, s, _ = kq.quantize_int8(xp)
    n = xp.numel()
    # the library call: one int8 x f32 product per block (type promotion,
    # one rounding, as the kernel); no single call quantises blockwise
    deq_lib = lambda: torch.mul(q.view(-1, C.BLOCK), s[:, None]).view(-1)
    if not same(torch, deq_lib(), kq.dequantize_int8(q, s)):
        fail("the library dequant differs from the kernel")
    runs = {
        "quantize_int8": (lambda: kq.quantize_int8(xp),
                          lambda: kq.quantize_int8_ref(xp), None),
        "dequantize_int8": (lambda: kq.dequantize_int8(q, s),
                            lambda: kq.dequantize_int8_ref(q, s), deq_lib),
        "quantize_ef_int8": (lambda: kq.quantize_ef_int8(xp, efp),
                             lambda: kq.quantize_ef_int8_ref(xp, efp), None),
    }
    out = {}
    for name, (run, plain, lib) in runs.items():
        rec = {"n": n, "max_abs_err": err[name],
               "kernel_ms": cuda_ms(torch, run, 20),
               "plain_ms": cuda_ms(torch, plain, 3),
               "library_ms": lib and cuda_ms(torch, lib, 20),
               "edge_cases": sorted(cases)}
        flops, nbytes = kq.work(name, n)
        bound(flops, nbytes, "float32", rec)
        rec["kernel_gb_per_s"] = nbytes / rec["kernel_ms"] / 1e6
        print(json.dumps({name: rec}), flush=True)
        out[name] = rec
    return out


def coll_inputs(torch, rank):
    """Rank ``rank``'s x and EF residual for the collectives phase, on the
    host, from a seed."""
    gen = torch.Generator().manual_seed(100 + rank)
    return (torch.randn(COLL_N, generator=gen),
            0.01 * torch.randn(COLL_N // 2, generator=gen))


def collectives_rank(rank):
    """One rank of the collectives phase: 2x2 grid, the card shared over
    gloo."""
    import torch
    from repro_torch.core.collectives import multilevel_psum
    from repro_torch.kernels import quant as kq
    from repro_torch.launch.mesh import make_grid

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    grid = make_grid(2, 2, dev)
    x, ef = (t.to(dev) for t in coll_inputs(torch, rank))
    for f in (kq.quantize_int8, kq.dequantize_int8, kq.quantize_ef_int8):
        f.launches = 0
    slow, fast = grid.slow, grid.fast
    out = {"plain": multilevel_psum(x, slow, fast),
           "int8": multilevel_psum(x, slow, fast, True)}
    out["int8_ef"], out["int8_ef_new"] = multilevel_psum(x, slow, fast, True,
                                                         ef)
    torch.cuda.synchronize()
    return {"out": {k: v.cpu().numpy() for k, v in out.items()},
            "launches": {f.__name__: f.launches for f in (
                kq.quantize_int8, kq.dequantize_int8, kq.quantize_ef_int8)},
            "backend": grid.backend, "staging": grid.staging,
            "staged_bytes": grid.staged_bytes,
            "slow_wire_bytes": grid.slow.wire_bytes}


def collectives_phase(torch, pool) -> dict:
    """``multilevel_psum`` plain, int8 and int8 + EF on four ranks sharing
    the card (``pool``: each rank's ``pool4_rank`` result), against the
    same sums in this process (the plain versions on the card): every sum
    over two ranks is exact, so bit for bit."""
    from repro_torch.core import compression as C

    res = [r["10"] for r in pool]
    wall = max(r["wall_s"]["10"] for r in pool)
    ins = [[t.cuda() for t in coll_inputs(torch, r)] for r in range(4)]
    pods = [ins[2 * p][0] + ins[2 * p + 1][0] for p in range(2)]
    n = COLL_N // 2
    want = {"plain": pods[0] + pods[1], "int8": [], "int8_ef": []}
    new_ef = {}
    for d in range(2):
        parts, parts_ef = [], []
        for p in range(2):
            chunk, _ = C.pad_to_block(pods[p][d * n:(d + 1) * n])
            parts.append(C.dequantize_int8(*C.quantize_int8(chunk))[:n])
            efp, _ = C.pad_to_block(ins[2 * p + d][1])
            q, s, r = C.quantize_ef_int8(chunk, efp)
            parts_ef.append(C.dequantize_int8(q, s)[:n])
            new_ef[2 * p + d] = r[:n]
        want["int8"].append(parts[0] + parts[1])
        want["int8_ef"].append(parts_ef[0] + parts_ef[1])
    want["int8"] = torch.cat(want["int8"])
    want["int8_ef"] = torch.cat(want["int8_ef"])
    for r, got in enumerate(res):
        for k in ("plain", "int8", "int8_ef"):
            if not same(torch, torch.from_numpy(got["out"][k]).cuda(),
                        want[k]):
                fail(f"collectives: rank {r} {k} differs from the sum in "
                     f"one process")
        if not same(torch, torch.from_numpy(got["out"]["int8_ef_new"]).cuda(),
                    new_ef[r]):
            fail(f"collectives: rank {r} new EF residual differs")
        if got["launches"] != {"quantize_int8": 1, "dequantize_int8": 2,
                               "quantize_ef_int8": 1}:
            fail(f"collectives: rank {r} launched {got['launches']}")
    launches = {k: sum(g["launches"][k] for g in res)
                for k in res[0]["launches"]}
    rec = {"grid": "2x2", "n": COLL_N, "backend": res[0]["backend"],
           "staging": res[0]["staging"], "wall_s": wall,
           "staged_bytes_per_rank": res[0]["staged_bytes"],
           "slow_wire_bytes_per_rank": res[0]["slow_wire_bytes"],
           "launches": launches}
    print(json.dumps({"collectives": rec}), flush=True)
    return rec


def pool4_rank(rank, jobs):
    """One of the four ranks that phases 10, 12, 24d, 25c (its 2x1x2
    grid), 26f, 31 and 33 (members 0-2; rank 3 leaves there) share, one
    spawn: each phase's rank body in turn,
    its counters from 0 as the body sets them, with its wall s.  ``jobs``:
    24d's (``tp_answer_rank``)."""
    import torch

    bodies = (("10", lambda: collectives_rank(rank)),
              ("12", lambda: {dev: grid_answer_steps(dev)
                              for dev in ("cuda", "cpu")}),
              ("26f", lambda: family_grid_rank(rank)),
              ("24d", lambda: tp_answer_rank(rank, jobs)),
              ("25c", lambda: tp_train_answer_rank(rank, 4)),
              ("31", lambda: headcut_rank(rank)),
              ("33", lambda: fallback_rank(rank)))
    out = {"wall_s": {}}
    for name, body in bodies:
        t0 = time.perf_counter()
        out[name] = body()
        out["wall_s"][name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


def grid_answer_steps(device):
    """This rank's 3 steps of the grid's f32 answer on ``device``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.mesh import make_grid
    from repro_torch.launch.step import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import stack_runs
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = dataclasses.replace(get_config("gpt-100m"), n_layers=2,
                              pattern=("attn",) * 2)
    grid = make_grid(2, 2, dev)
    opt_cfg = adamw.OptConfig(comm_mode="multilevel_compress", lr=1e-3,
                              warmup_steps=20, total_steps=3)
    params = stack_runs(tree_map(lambda t: t.float().to(dev), T.init_model(
        cfg, seed=0, device="cpu")), cfg)
    opt = adamw.shard_opt_state(adamw.init_opt_state(params, opt_cfg,
                                                     n_slow=2),
                                params, opt_cfg, grid)
    step = make_train_step(cfg, opt_cfg, grid, dev)
    pipe = DataPipeline(cfg, ShapeSpec("answer", "train", 256, 4))
    losses, m = [], []
    for i in range(3):
        params, opt, loss = step(params, opt, pipe.host_batch(i))
        losses.append(loss.item())
        if i < 2:
            # a copy: the next step updates the state in place
            m.append(opt["m"]["runs"][0]["attn"]["wq"].cpu().numpy().copy())
    return {"losses": losses, "m_wq": m}


def grid_answer(pool) -> None:
    """Phase 12: the grid's f32 answer, 2 layers of gpt-100m at full
    width, ``multilevel_compress`` on 2x2x1, 3 steps, on the card and then
    on the CPU (a grid of each), from ``pool`` (each rank's
    ``pool4_rank`` result)."""
    import numpy as np

    runs = {dev: [r["12"][dev] for r in pool] for dev in ("cuda", "cpu")}
    l_gpu, l_cpu = runs["cuda"][0]["losses"], runs["cpu"][0]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    share, m_rel = [], []        # per step, the worst rank
    for i in range(2):
        d = [(np.abs(g["m_wq"][i] - c["m_wq"][i]), np.abs(c["m_wq"][i]).max())
             for g, c in zip(runs["cuda"], runs["cpu"])]
        share.append(max(float((e > GRID_M_REL * top).mean())
                         for e, top in d))
        m_rel.append(max(float(e.max() / top) for e, top in d))
    print(json.dumps({"grid_train_f32_card_vs_cpu": {
        "grid": "2x2x1", "mode": "multilevel_compress", "losses_card": l_gpu,
        "losses_cpu": l_cpu, "max_rel_loss_diff": rel,
        "loss_tolerance": GRID_LOSS_TOL,
        "m_wq_share_differing_per_step": share,
        "m_wq_max_rel_diff_per_step": m_rel,
        "m_wq_share_tolerance": GRID_M_SHARE,
        "ranks_wall_s": max(r["wall_s"]["12"] for r in pool)}}), flush=True)
    if not math.isfinite(rel) or rel > GRID_LOSS_TOL:
        fail(f"2x2x1 f32 losses differ by {rel} (relative) between card "
             f"and CPU")
    if not all(x <= GRID_M_SHARE for x in share):
        fail(f"2x2x1 f32 Adam moments of wq differ by more than "
             f"{GRID_M_REL} of their largest in a share {share} of the "
             f"elements between card and CPU")


def wkv_inputs(torch, B, S, H, hd, decays, seed=0):
    """r, k, v, w (B,S,H,hd) and u (H,hd), f32 on the card, from a seeded
    generator: w from the reference kernel test's range (0.39, 0.99), the
    model's formula exp(-exp(clip(n, -8, 0.5))), or constant at either end
    of that clip."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v, n = (torch.randn((B, S, H, hd), generator=gen, device="cuda")
                  for _ in range(4))
    ends = {"clip": 0.5, "one": -8.0}
    if decays == "test":
        w = torch.sigmoid(n) * 0.6 + 0.39
    elif decays == "model":
        w = torch.exp(-torch.exp(n.clamp(-8, 0.5)))
    else:
        w = torch.exp(-torch.exp(torch.full_like(n, ends[decays])))
    u = 0.5 * torch.randn((H, hd), generator=gen, device="cuda")
    return r, k, v, w, u


def pad_wkv(torch, ins, S):
    """Pad r, k, v, w to S steps as rwkv6_fwd does: zeros, and w = 1."""
    r, k, v, w, u = ins
    pad = (0, 0, 0, 0, 0, S - r.shape[1])
    F = torch.nn.functional
    return [F.pad(t, pad) for t in (r, k, v)] + [F.pad(w, pad, value=1.0), u]


def ptxas_of(log: str, kernel: str) -> dict:
    """Registers and spilled bytes of each instance of ``kernel`` in a
    ``-Xptxas -v`` log, by its template arguments."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            cur = None
            if kernel in name:
                cur = kernel + "".join(
                    f"<{a}>" for a in re.findall(r"L[ib](\d+)E", name))
                out[cur] = {}
        elif cur:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[cur]["spill_stores"] = int(m.group(1))
                out[cur]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[cur]["registers"] = int(m.group(1))
    return out


def wkv_instance(plan: dict, hd: int) -> str:
    """The ``ptxas_of`` key of the WKV instance a launch plan runs (rows by
    16-byte copies where hd % 4 == 0: the inputs here are aligned)."""
    return (f"wkv_kernel<{plan['chunk_width']}><{plan['head_width']}>"
            f"<{int(plan['exact'])}><{4 if hd % 4 == 0 else 1}>")


def pad_wkv_chunks(torch, ins, chunk, C):
    """A pad step (zero r, k, v; w = 1) after each chunk's last, to C."""
    r, k, v, w, u = ins
    B, S, H, hd = r.shape
    out = []
    for t, fill in ((r, 0.0), (k, 0.0), (v, 0.0), (w, 1.0)):
        x = torch.full((B, S // chunk, C, H, hd), fill, device=t.device)
        x[:, :, :chunk] = t.reshape(B, S // chunk, chunk, H, hd)
        out.append(x.reshape(B, -1, H, hd))
    return out + [u]


def pad_wkv_head(torch, ins, W):
    """Zero columns past hd to W (w = 1 there)."""
    F = torch.nn.functional
    r, k, v, w, u = ins
    pad = (0, W - r.shape[-1])
    return [F.pad(t, pad) for t in (r, k, v)] + [F.pad(w, pad, value=1.0),
                                                 F.pad(u, pad)]


def wkv_width_phase(torch, kw, ptxas, get_config) -> int:
    """36: the WKV kernel's instances beside (16, 64) against the plain
    version (``WKV_WIDE_SHAPES``, o and the final state within WKV_TOL of
    their scale); o and the state bit for bit across n_split 1, 2, twice
    the head's floor and the launcher's choice (1 and 2 raised to the
    floor above hd 64), and a padded
    chunk or head against the exact instance on the inputs padded by the
    caller; each shape's time beside the plain version's and its bound,
    its launch and its instance's registers and spills.  Then
    rwkv6-1.6b's widths with heads of 128 (``RWKV_WIDE``), card against
    CPU as phase 15 holds them.  Returns that run's WKV launches."""
    t0 = time.perf_counter()
    for name, B, S, H, hd, chunk, decays in WKV_WIDE_SHAPES:
        ins = wkv_inputs(torch, B, S, H, hd, decays, seed=36)
        o, st = kw.wkv_chunked(*ins, chunk=chunk, return_state=True)
        torch.cuda.synchronize()
        o_ref, st_ref = kw.wkv_chunk_scan_ref(*ins, chunk)
        errs = {}
        for what, got, want in (("o", o, o_ref), ("S_fin", st, st_ref)):
            err = (got - want).abs().max().item()
            lim = WKV_TOL * max(1.0, want.abs().max().item())
            if not (torch.isfinite(got).all() and err <= lim):
                fail(f"phase 36 wkv {name} {what}: max abs err {err} > {lim}")
            errs[what] = err
        plan = kw.launch_plan(B, H, hd, chunk=chunk)
        floor = kw.launch_plan(B, H, hd, 1, chunk=chunk)["n_split"]
        splits = {}
        for n in (1, 2, min(hd, 2 * floor), 0):
            o_n, st_n = kw.wkv_chunked(*ins, chunk=chunk, return_state=True,
                                       n_split=n)
            torch.cuda.synchronize()
            splits[n] = kw.launch_plan(B, H, hd, n, chunk=chunk)["n_split"]
            if not (torch.equal(o_n, o) and torch.equal(st_n, st)):
                fail(f"phase 36 wkv {name}: n_split {n} changes the bits")
        C, W = plan["chunk_width"], plan["head_width"]
        padded = []
        if chunk != C:
            po, ps = kw.wkv_chunked(*pad_wkv_chunks(torch, ins, chunk, C),
                                    chunk=C, return_state=True)
            po = po.reshape(B, S // chunk, C, H, hd)[:, :, :chunk]
            if not (torch.equal(po.reshape(B, S, H, hd), o)
                    and torch.equal(ps, st)):
                fail(f"phase 36 wkv {name}: the padded chunk differs from "
                     f"chunk {C} on the inputs padded by the caller")
            padded.append(f"chunk {chunk} of {C}")
        if hd != W:
            po, ps = kw.wkv_chunked(*pad_wkv_head(torch, ins, W), chunk=chunk,
                                    return_state=True)
            if not (torch.equal(po[..., :hd], o)
                    and torch.equal(ps[..., :hd, :hd], st)):
                fail(f"phase 36 wkv {name}: the padded head differs from "
                     f"width {W} on the inputs padded by the caller")
            padded.append(f"head {hd} of {W}")
        flops, nbytes = kw.work(B, S, H, hd, chunk)
        rec = {"shape": name, "B": B, "S": S, "H": H, "hd": hd,
               "chunk": chunk, "decays": decays,
               "max_abs_err": max(errs.values()), "max_abs_err_o_S": errs,
               "kernel_ms": cuda_ms(torch, lambda: kw.wkv_chunked(
                   *ins, chunk=chunk, return_state=True), 20),
               "plain_ms": cuda_ms(torch, lambda: kw.wkv_chunk_scan_ref(
                   *ins, chunk), 3),
               "flops": flops, "bytes": nbytes, "library_ms": None,
               "launch": plan, "n_split_bits_equal": splits,
               "padded_bits_equal_caller_padded": padded}
        bound(flops, nbytes, "float32", rec)
        key = wkv_instance(plan, hd)
        rec["ptxas"] = {key: ptxas.get(key)}
        print(json.dumps({"wkv_36": rec}), flush=True)
    t_kernels = time.perf_counter() - t0
    cfg = dataclasses.replace(
        get_config("rwkv6-1.6b"), rwkv_head_dim=RWKV_WIDE["rwkv_head_dim"],
        n_layers=RWKV_WIDE["layers"], pattern=("rwkv6",) * RWKV_WIDE["layers"])
    rec = rwkv_answer(torch, get_config, cfg, RWKV_WIDE["batch"],
                      RWKV_WIDE["prompt"], "rwkv6_hd128_f32_card_vs_cpu")
    if rec["wkv_launches"] != cfg.n_layers:
        fail(f"phase 36: the hd-128 prefill launched {rec['wkv_launches']} "
             f"WKV kernels, expected {cfg.n_layers}")
    print(json.dumps({"phase_36": {
        "shapes": len(WKV_WIDE_SHAPES), "kernels_wall_s": t_kernels,
        "wall_s": time.perf_counter() - t0}}), flush=True)
    return rec["wkv_launches"]


def parent_wkv(path):
    """An earlier WKV kernel's library, for timing in turns: its wkv_fwd
    called as this one is (the launcher's choice where it takes n_split,
    chunk 16 where it takes a chunk)."""
    lib = ctypes.CDLL(str(Path(path).resolve()))
    P, I = ctypes.c_void_p, ctypes.c_int
    split = hasattr(lib, "wkv_plan")
    chunk = hasattr(lib, "wkv_supported")
    lib.wkv_fwd.argtypes = [P] * 7 + [I] * (5 + chunk) + [P] + [I] * split
    lib.wkv_fwd.restype = I

    def run(torch, r, k, v, w, u, o, st):
        B, S, H, hd = r.shape
        err = lib.wkv_fwd(*[t.data_ptr() for t in (r, k, v, w, u, o, st)],
                          B, S, H, hd, *[16] * chunk, r.device.index,
                          torch.cuda.current_stream().cuda_stream,
                          *[0] * split)
        if err:
            fail(f"the parent WKV kernel failed to launch: {err}")
    return run


def wkv_phase(torch, kw, shape, ptxas, parents=None) -> dict:
    """The WKV kernel against its plain version on one shape, o and the
    final state; its time beside the plain version's and the bound.  With
    ``parents`` (a dict, maybe empty) also its time at 1, 2 and 4 blocks a
    head, and each earlier kernel held to the plain version and timed in
    turns with it."""
    name, B, S0, H, hd, decays = shape
    ins = wkv_inputs(torch, B, S0, H, hd, decays)
    S = S0 + (-S0) % kw.CHUNK
    if S != S0:
        ins = pad_wkv(torch, ins, S)
    o, st = kw.wkv_chunked(*ins, return_state=True)
    torch.cuda.synchronize()
    o_ref, st_ref = kw.wkv_chunk_scan_ref(*ins, kw.CHUNK)
    errs = {}
    for what, got, want in (("o", o, o_ref), ("S_fin", st, st_ref)):
        err = (got - want).abs().max().item()
        lim = WKV_TOL * max(1.0, want.abs().max().item())
        if not (torch.isfinite(got).all() and err <= lim):
            fail(f"wkv {name} {what}: max abs err {err} > {lim}")
        errs[what] = err
    if S != S0:
        # the pad leaves the state and the real outputs exact
        o2, st2 = kw.wkv_chunked(*pad_wkv(torch, ins, S + kw.CHUNK),
                                 return_state=True)
        torch.cuda.synchronize()
        if not (torch.equal(st, st2) and torch.equal(o[:, :S0], o2[:, :S0])):
            fail(f"wkv {name}: the state or outputs move across the pad")
    flops, nbytes = kw.work(B, S, H, hd)
    rec = {"shape": name, "B": B, "S": S, "H": H, "hd": hd,
           "decays": decays, "max_abs_err": max(errs.values()),
           "max_abs_err_o_S": errs,
           "kernel_ms": cuda_ms(torch, lambda: kw.wkv_chunked(
               *ins, return_state=True), 20),
           "plain_ms": cuda_ms(torch, lambda: kw.wkv_chunk_scan_ref(
               *ins, kw.CHUNK), 3),
           "bound_rates": "3.35 TB/s; 67 TFLOP/s f32 (non-tensor)",
           "flops": flops, "bytes": nbytes, "library_ms": None}
    rec["kernel_gflops"] = flops / rec["kernel_ms"] / 1e6
    bound(flops, nbytes, "float32", rec)
    rec["launch"] = kw.launch_plan(B, H, hd)
    rec["ptxas"] = {wkv_instance(rec["launch"], hd): ptxas.get(
        wkv_instance(rec["launch"], hd))}
    if parents is not None:
        rec["n_split_ms"] = {n: cuda_ms(torch, lambda: kw.wkv_chunked(
            *ins, return_state=True, n_split=n), 20) for n in (1, 2, 4)}
        o_p = torch.empty_like(o)
        st_p = torch.empty_like(st)
        runs = {"kernel": lambda: kw.wkv_chunked(*ins, return_state=True)}
        for lib, run in parents.items():
            run(torch, *ins, o_p, st_p)
            torch.cuda.synchronize()
            # an earlier kernel computes the same function: the same bound
            for what, got, want in (("o", o_p, o_ref),
                                    ("S_fin", st_p, st_ref)):
                err = (got - want).abs().max().item()
                if not err <= WKV_TOL * max(1.0, want.abs().max().item()):
                    fail(f"the WKV kernel {lib}'s {what} misses by {err}")
            rec.setdefault("parent_bits_equal", {})[lib] = bool(
                torch.equal(o_p, o) and torch.equal(st_p, st))
            runs[lib] = lambda run=run: run(torch, *ins, o_p, st_p)
        if parents:
            order = list(runs) + list(runs)[::-1]
            rec["turns_ms"] = [[n, cuda_ms(torch, runs[n], 50)]
                               for n in order]
    print(json.dumps({"wkv": rec}), flush=True)
    return rec


def prompt_inputs(torch, cfg, B, L, P, seed):
    """A (B, L) prompt from a seed, and P positions of bf16 patch embeds
    (a vision frontend) or encoder frames (enc-dec), on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    inputs = {"tokens": torch.randint(0, cfg.vocab, (B, L), generator=gen)}
    if P:
        e = torch.randn((B, P, cfg.d_model), generator=gen)
        inputs["src_embeds" if cfg.enc_dec else "embeds"] = \
            e.to(torch.bfloat16)
    return inputs


def dense_serve(torch, cfg, params, B, L, P=0, grid=None, align=1,
                gen=DENSE_GEN):
    """Prefill a (B, L) prompt from a seed (after P prefix positions) on
    the card and decode greedily to ``gen`` tokens through
    make_prefill_fn/make_decode_fn (on this rank's shard where ``grid``
    has a model axis), the cache sized for the tokens rounded up to a
    multiple of ``align``.  Returns the wall times, the tokens and each
    step's logits."""
    from repro_torch.launch.step import make_decode_fn, make_prefill_fn

    inputs = {k: v.cuda()
              for k, v in prompt_inputs(torch, cfg, B, L, P, L).items()}
    pre = 0 if cfg.enc_dec else P
    s_max = pre + L + gen - 1
    s_max += (-s_max) % align
    prefill = make_prefill_fn(cfg, s_max, grid)
    decode = make_decode_fn(cfg, grid, s_max)
    calls = (lambda: grid.tp.calls) if grid is not None else (lambda: 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c0 = calls()
    logits, cache, pos = prefill(params, inputs)
    c1 = calls()
    out, lgs = [logits[:, -1].argmax(-1, keepdim=True)], [logits]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode(params, cache, out[-1], pos + i)
        out.append(logits[:, -1].argmax(-1, keepdim=True))
        lgs.append(logits)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_step": (t2 - t1) * 1e3 / (gen - 1),
            "tokens": torch.cat(out, 1), "logits": lgs, "wall_s": t2 - t0,
            "collectives_prefill": c1 - c0,
            "collectives_per_decode_step": (calls() - c1) / (gen - 1)}


def leaf_errs(torch, got, want) -> tuple[dict, bool]:
    """How far one cache leaf on the card is from the CPU's, and whether
    it is within RWKV_TOL of its scale (an f32 leaf) or one bf16 ulp (a
    leaf stored in bf16)."""
    a, b = got.cpu().float(), want.float()
    d, top = (a - b).abs(), b.abs().max().item()
    if want.dtype == torch.float32:
        ok = d.max().item() <= RWKV_TOL * top
    else:
        ok = bool((d <= BF16_ULP * b.abs() + 1e-6 * top).all())
    return {"max_abs_err": d.max().item(), "max_abs": top,
            "differing": int((d > 0).sum().item())}, ok


def rwkv_answer(torch, get_config, cfg=None, B=1, L=300,
                tag="rwkv6_f32_card_vs_cpu") -> dict:
    """rwkv6-1.6b at full width (or ``cfg``), 2 layers, f32: a (B, L)
    prefill and 4 greedy steps on the card and on the CPU.  Each step runs on both from
    the CPU's cache and token, so every leaf is held to one step's
    rounding; x_tm and x_cm are stored in bf16, so a free run lets a row
    rounded the other way feed the next step and the two runs drift apart
    ulp by ulp.  The free run's logits are held to RWKV_TOL as well, and
    its drift is printed."""
    from repro_torch.launch.step import make_decode_fn, make_prefill_fn
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    from repro_torch.kernels import wkv as kw

    cfg = cfg or dataclasses.replace(get_config("rwkv6-1.6b"), n_layers=2,
                                     pattern=("rwkv6",) * 2)
    p_cpu = tree_map(lambda t: t.float(),
                     T.init_model(cfg, seed=0, device="cpu"))
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    prompt = torch.randint(0, cfg.vocab, (B, L),
                           generator=torch.Generator().manual_seed(L))
    launches = kw.wkv_chunked.launches
    prefill = make_prefill_fn(cfg, L + (-L) % 16)
    decode = make_decode_fn(cfg)
    lg_c, cache_c, pos = prefill(p_cpu, {"tokens": prompt})
    lg_g, cache_g, _ = prefill(p_gpu, {"tokens": prompt.cuda()})
    free = cache_g
    rec, fed = {"steps": []}, []
    for i in range(5):
        if i:
            tok = lg_c[:, -1].argmax(-1, keepdim=True)
            fed.append(tok)
            start = tree_map(lambda t: t.cuda(), cache_c)
            lg_c, cache_c = decode(p_cpu, cache_c, tok, pos + i - 1)
            lg_g, cache_g = decode(p_gpu, start, tok.cuda(), pos + i - 1)
        step = {"logits_max_rel_err": (lg_g.cpu() - lg_c).abs().max().item()
                / max(1.0, lg_c.abs().max().item())}
        ok = step["logits_max_rel_err"] <= RWKV_TOL
        for name in ("S", "x_tm", "x_cm"):
            step[name], leaf_ok = leaf_errs(torch, cache_g[0][name],
                                            cache_c[0][name])
            ok &= leaf_ok
        rec["steps"].append(step)
        if not ok:
            fail(f"rwkv6 f32 {'prefill' if not i else f'step {i}'} on the "
                 f"card differs from the CPU: {step}")
    # the free run: the card's own cache from its prefill on
    for i, tok in enumerate(fed):
        lg_f, free = decode(p_gpu, free, tok.cuda(), pos + i)
    rec["free_run_logits_max_rel_err"] = (lg_f.cpu() - lg_c).abs().max() \
        .item() / max(1.0, lg_c.abs().max().item())
    rec["free_run_cache"] = {name: leaf_errs(torch, free[0][name],
                                             cache_c[0][name])[0]
                             for name in ("S", "x_tm", "x_cm")}
    rec["wkv_launches"] = kw.wkv_chunked.launches - launches
    print(json.dumps({tag: {
        "layers": cfg.n_layers, "batch": B, "prompt": L,
        "rwkv_head_dim": cfg.rwkv_head_dim, "decode_steps": 4,
        "tolerance": RWKV_TOL, **rec}}), flush=True)
    if not rec["free_run_logits_max_rel_err"] <= RWKV_TOL:
        fail(f"rwkv6 f32 free-run logits differ by "
             f"{rec['free_run_logits_max_rel_err']} of their scale")
    return rec


def tree_topology():
    """The topology of phase 16: 2 pods of 2 boards of 2 ranks, the shape
    of ``examples/tree_collectives_on_mesh.py``; its first stratum is a
    2 x 4 grid's pods.  The card's link classes are not measured yet
    (ROADMAP.md, Queue 1 item 8: "The NCCL path, one card per rank"), so
    the levels carry names only: policy "paper" builds its trees from the
    coordinates."""
    from repro_torch.core.topology import Level, Topology

    return Topology([[i // 4, i // 2] for i in range(TREE_WORLD)],
                    [Level(n, 0.0, 1.0) for n in ("pod", "board", "rank")])


def tree_input(torch, key, rank):
    """Rank ``rank``'s operand ``key`` of phase 16, made on the card from a
    seed: bf16 parameters and an f32 gradient at gpt-100m's width, 1 MiB
    per rank for the other ops (``sc``: the root's [8, ...] scatter
    buffer), and the EF residual of the compressed tree sync."""
    from repro_torch.core import collectives as C
    from repro_torch.core import compression

    n = {"params": GPT_100M_PARAMS, "grad": GPT_100M_PARAMS,
         "x": TREE_SMALL, "g": TREE_SMALL, "sc": TREE_WORLD * TREE_SMALL}
    if key == "ef":
        like = [torch.empty(s, device="meta") for s in GPT_100M_LEAVES]
        n["ef"] = C.compress_ef_zeros(like, TREE_GRID[1],
                                      tile=compression.QTILE).numel()
    gen = torch.Generator(device="cuda").manual_seed(TREE_SEEDS[key] + rank)
    t = torch.randn(n[key], generator=gen, device="cuda")
    if key == "params":
        return t.to(torch.bfloat16)
    if key == "sc":
        return t.reshape(TREE_WORLD, TREE_SMALL)
    return 0.01 * t if key == "ef" else t


def leaves_of(flat):
    """gpt-100m's leaves as views of one flat buffer."""
    out, off = {}, 0
    for i, shape in enumerate(GPT_100M_LEAVES):
        n = math.prod(shape)
        out[f"leaf{i}"] = flat[off:off + n].reshape(shape)
        off += n
    return out


def flat_of(torch, tree):
    return torch.cat([tree[f"leaf{i}"].reshape(-1)
                      for i in range(len(GPT_100M_LEAVES))])


def digest(t) -> str:
    """SHA-256 of a tensor's bytes: equal digests are bit for bit."""
    import hashlib
    import torch

    b = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
    return hashlib.sha256(b.numpy().tobytes()).hexdigest()


def tree_rank(rank, disc_dir):
    """One of the 8 ranks of phase 16, sharing the card over gloo: the
    seven collectives on the ``"p2p"`` backend (2 x 2 x 2 topology), then
    on the ``"torch"`` backend of a 4 x 2 grid with ``allreduce_tree`` of
    gpt-100m's leaves, each op timed between barriers and its output kept
    as a digest (or, where gloo sums more than two terms, as an array);
    then phase 19's discovery (``discovery_rank``), its topology persisted
    in ``disc_dir``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import Communicator
    from repro_torch.kernels import quant as kq
    from repro_torch.launch.mesh import grid_communicator, make_grid

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    topo = tree_topology()
    ins = {k: tree_input(torch, k, rank)
           for k in ("params", "grad", "x", "g", "sc", "ef")}
    p2p = Communicator(topo, policy="paper", backend="p2p")
    rec = {"p2p": {}, "torch": {}}
    arrays = {}

    def timed(backend, name, fn, keep=False):
        peers = p2p.backend.peers
        b0, m0 = dict(peers.link_bytes), dict(peers.link_messages)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        r = {"ms": (time.perf_counter() - t0) * 1e3, "digest": digest(out)}
        if backend == "p2p":
            r["link_bytes"] = {k: v - b0[k]
                               for k, v in peers.link_bytes.items()}
            r["link_messages"] = {k: v - m0[k]
                                  for k, v in peers.link_messages.items()}
        rec[backend][name] = r
        if keep:
            arrays[f"{backend}/{name}"] = out.cpu().numpy()

    def seven(backend, comm, bcast_roots):
        x, g, sc = ins["x"], ins["g"], ins["sc"]
        for root in bcast_roots:
            timed(backend, f"bcast_{root}",
                  lambda: comm.bcast(x, root=root))
        for root in TREE_ROOTS:
            timed(backend, f"reduce_{root}",
                  lambda: comm.reduce(x, root=root),
                  keep=backend == "torch" and rank == root)
            timed(backend, f"gather_{root}",
                  lambda: comm.gather(g, root=root))
            timed(backend, f"scatter_{root}",
                  lambda: comm.scatter(sc, root=root))
        timed(backend, "allgather", lambda: comm.allgather(g))
        timed(backend, "barrier", lambda: comm.barrier())

    # the p2p backend: the weight broadcast and the gradient all-reduce at
    # gpt-100m's width, the rest at 1 MiB per rank
    timed("p2p", "bcast_params_3", lambda: p2p.bcast(ins["params"], root=3))
    cache0 = tuple(p2p.cache_info())
    timed("p2p", "bcast_params_3_again",
          lambda: p2p.bcast(ins["params"], root=3))
    cache1 = tuple(p2p.cache_info())
    timed("p2p", "allreduce_grad", lambda: p2p.allreduce(ins["grad"]))
    seven("p2p", p2p, ())
    # the torch backend on a 4 x 2 grid (the topology's board pairs)
    grid = make_grid(*TREE_GRID, dev)
    tc = grid_communicator(grid, list(topo.levels))
    seven("torch", tc, TREE_ROOTS)
    timed("torch", "allreduce", lambda: tc.allreduce(ins["x"]), keep=True)
    for f in (kq.quantize_int8, kq.dequantize_int8, kq.quantize_ef_int8):
        f.launches = 0
    tree = leaves_of(ins["grad"])
    launches = {}
    for name, kw in (("multilevel", {}),
                     ("multilevel_compress", {"mode": "multilevel_compress"}),
                     ("multilevel_compress_ef", {
                         "mode": "multilevel_compress", "ef": ins["ef"]})):
        def sync(kw=kw):
            out = tc.allreduce_tree(tree, **kw)
            if "ef" in kw:
                return torch.cat([flat_of(torch, out[0]), out[1]])
            return flat_of(torch, out)
        timed("torch", f"allreduce_tree_{name}", sync,
              keep=name == "multilevel")
        launches[name] = {f.__name__: f.launches for f in (
            kq.quantize_int8, kq.dequantize_int8, kq.quantize_ef_int8)}
    return {"rec": rec, "arrays": arrays, "cache": (cache0, cache1),
            "launches": launches, "backend": grid.backend,
            "staging": grid.staging,
            "staged_bytes": {"p2p": p2p.backend.peers.staged_bytes,
                             "torch": grid.staged_bytes},
            "discovery": discovery_rank(torch, rank, disc_dir, ins["x"])}


def discovery_rank(torch, rank, disc_dir, x):
    """Phase 19 on one rank: the environment's topology, the timed probes,
    the topology fitted from them (persisted to this rank's file), the
    ``"p2p"`` bcast of ``x`` (1 MiB) from rank ``DISC_ROOT`` on it, and
    ``discover("device", path=)`` loading that file again."""
    import torch.distributed as dist
    from repro_torch.core import Communicator
    from repro_torch.core import discovery as D

    env = D.environment_topology()
    path = f"{disc_dir}/rank{rank}.json"
    t0 = time.perf_counter()
    probes = D.device_probes(device="cuda")
    probe_s = time.perf_counter() - t0
    comm = Communicator.from_probes(probes, path=path, backend="p2p",
                                    policy=DISC_POLICY)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = comm.bcast(x, root=DISC_ROOT)
    torch.cuda.synchronize()
    bcast_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    again = D.discover("device", path=path)
    load_s = time.perf_counter() - t0
    return {"env": env.to_json(), "times": probes.times,
            "sizes": probes.sizes, "probe_s": probe_s,
            "topo": comm.topo.to_json(), "again": again.to_json(),
            "load_s": load_s, "bcast_ms": bcast_ms, "bcast": digest(out),
            "link_bytes": dict(comm.backend.peers.link_bytes)}


def replay_lowered(torch, xs, lowered):
    """``tree_exec.run_lowered`` for every rank in one process: ``xs[r]``
    is rank r's operand; each round's sends carry what their sources held
    before the round, and a receiver folds ``cur + recv`` or copies."""
    C = max(1, lowered.nchunks)
    bufs = []
    for x in xs:
        flat = x.reshape(-1)
        pad = (-flat.numel()) % C
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        bufs.append(flat.reshape(C, -1).clone())
    for rnd in lowered.device_rounds():
        sent = {(s, c): bufs[s][c].clone() for s, _, c, _ in rnd}
        for s, d, c, kind in rnd:
            recv = sent[(s, c)]
            bufs[d][c] = bufs[d][c] + recv if kind == "reduce" else recv
    return [b.reshape(-1)[:x.numel()].reshape(x.shape)
            for b, x in zip(bufs, xs)]


def replay_bcast(xs, tree):
    """``tree_exec.tree_bcast`` for every rank in one process."""
    from repro_torch.core.tree_exec import tree_rounds

    xs, have = list(xs), {tree.root}
    for rnd in tree_rounds(tree):
        sent = {s: xs[s] for s, _ in rnd}
        for s, d in rnd:
            if d not in have:
                xs[d] = sent[s]
            have.add(d)
    return xs


def replay_reduce(xs, tree):
    """``tree_exec.tree_reduce`` for every rank in one process: children
    send up in reversed round order, the parent folds ``cur + recv``."""
    from repro_torch.core.tree_exec import tree_rounds

    xs = list(xs)
    for rnd in reversed(tree_rounds(tree)):
        sent = {d: xs[d] for _, d in rnd}
        for s, d in rnd:
            xs[s] = xs[s] + sent[d]
    return xs


def replay_gather(torch, gs, tree):
    """``tree_exec.tree_gather_flat`` for every rank in one process."""
    bufs = []
    for r, g in enumerate(gs):
        b = g.new_zeros((len(gs),) + tuple(g.shape))
        b[r] = g
        bufs.append(b)
    return replay_reduce(bufs, tree)


def p2p_want(torch, comm, grads):
    """The p2p backend's outputs for every rank, replayed in one process
    from the plans' ``Lowered.device_rounds()`` and ``tree_rounds``."""
    ins = {k: [tree_input(torch, k, r) for r in range(TREE_WORLD)]
           for k in ("x", "g", "sc")}
    want = {}
    params = tree_input(torch, "params", 3)
    nb = params.numel() * params.element_size()
    want["bcast_params_3"] = replay_lowered(
        torch, [params if r == 3 else torch.zeros_like(params)
                for r in range(TREE_WORLD)],
        comm.plan("bcast", root=3, nbytes=nb).lower(nb))
    want["bcast_params_3_again"] = want["bcast_params_3"]
    nb = grads[0].numel() * 4
    want["allreduce_grad"] = replay_lowered(
        torch, grads, comm.plan("allreduce", nbytes=nb).lower(nb))
    for root in TREE_ROOTS:
        tree = comm.plan("reduce", root=root).tree
        r = replay_reduce(ins["x"], tree)[root]
        want[f"reduce_{root}"] = [r if i == root else torch.zeros_like(r)
                                  for i in range(TREE_WORLD)]
        b = replay_gather(torch, ins["g"], tree)[root]
        want[f"gather_{root}"] = [b if i == root else torch.zeros_like(b)
                                  for i in range(TREE_WORLD)]
        full = replay_bcast(ins["sc"], tree)
        want[f"scatter_{root}"] = [full[i][i] for i in range(TREE_WORLD)]
    tree = comm.plan("allgather").tree
    want["allgather"] = replay_bcast(replay_gather(torch, ins["g"], tree),
                                     tree)
    tree = comm.plan("barrier").tree
    token = torch.zeros((), dtype=torch.float32)
    want["barrier"] = replay_bcast(replay_reduce([token] * TREE_WORLD, tree),
                                   tree)
    return want


def torch_want(torch, grads):
    """The torch backend's outputs for every rank, from the same sums in
    one process: exact where a sum has two terms or the port sums the
    dequantised pods; where gloo adds more terms its own way, the
    reference the tolerance is held to."""
    from repro_torch.core import compression as C

    ins = {k: [tree_input(torch, k, r) for r in range(TREE_WORLD)]
           for k in ("x", "g", "sc")}
    W, (pods, data) = TREE_WORLD, TREE_GRID
    want, ref = {}, {}
    total = sum(ins["x"][1:], ins["x"][0])
    for root in TREE_ROOTS:
        want[f"bcast_{root}"] = [ins["x"][root]] * W
        # zeros off the root; the root's sum is held to the tolerance
        want[f"reduce_{root}"] = [None if i == root else
                                  torch.zeros_like(total) for i in range(W)]
        ref[f"reduce_{root}"] = total
        stacked = torch.stack(ins["g"])
        want[f"gather_{root}"] = [stacked if i == root else
                                  torch.zeros_like(stacked) for i in range(W)]
        want[f"scatter_{root}"] = [ins["sc"][root][i] for i in range(W)]
    want["allgather"] = [torch.stack(ins["g"])] * W
    want["barrier"] = [torch.zeros((), dtype=torch.float32)] * W
    ref["allreduce"] = total
    # the gradient tree: pod sums over the fast axis of 2 are exact
    pod = [grads[data * p] + grads[data * p + 1] for p in range(pods)]
    ref["allreduce_tree_multilevel"] = sum(pod[1:], pod[0])
    n = GPT_100M_PARAMS // data
    full = []
    for d in range(data):
        parts = []
        for p in range(pods):
            chunk, _ = C.pad_to_block(pod[p][d * n:(d + 1) * n])
            parts.append(C.dequantize_int8(*C.quantize_int8(chunk))[:n])
        full.append(sum(parts[1:], parts[0]))
    want["allreduce_tree_multilevel_compress"] = [torch.cat(full)] * W
    efs = [tree_input(torch, "ef", r) for r in range(W)]
    n = efs[0].numel()
    padded = [torch.nn.functional.pad(p, (0, n * data - p.numel()))
              for p in pod]
    full, new_ef = [], [None] * W
    for d in range(data):
        parts = []
        for p in range(pods):
            chunk, _ = C.pad_to_block(padded[p][d * n:(d + 1) * n])
            efp, _ = C.pad_to_block(efs[data * p + d])
            q, s, r = C.quantize_ef_int8(chunk, efp)
            parts.append(C.dequantize_int8(q, s)[:n])
            new_ef[data * p + d] = r[:n]
        full.append(sum(parts[1:], parts[0]))
    full = torch.cat(full)[:GPT_100M_PARAMS]
    want["allreduce_tree_multilevel_compress_ef"] = [
        torch.cat([full, e]) for e in new_ef]
    return want, ref


def digests(want: dict) -> dict:
    """Each list of expected tensors as digests (None stays None), each
    distinct tensor hashed once."""
    seen = {}
    return {k: [None if t is None else seen.setdefault(id(t), digest(t))
                for t in v] for k, v in want.items()}


def tree_phase(torch) -> dict:
    """Phase 16: the seven collectives by tree on 8 ranks sharing the card
    (gloo, staged through host memory), held bit for bit to their replay
    in one process, with the link bytes, the slow-level messages and the
    plan cache checked against the plans, and the int8 kernels' launches
    against what the compressed syncs imply."""
    from repro_torch.core import Communicator
    from repro_torch.launch.mesh import run_ranks

    torch.cuda.empty_cache()     # the ranks share the card with this process
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="repro_torch_disc_") as tmp:
        res = run_ranks(tree_rank, TREE_WORLD, "gloo", (tmp,),
                        timeout=900.0)
    wall = time.perf_counter() - t0
    topo = tree_topology()
    comm = Communicator(topo, policy="paper")
    grads = [tree_input(torch, "grad", r) for r in range(TREE_WORLD)]
    checks = {}
    for backend in ("p2p", "torch"):
        if backend == "p2p":
            want, ref = digests(p2p_want(torch, comm, grads)), {}
        else:
            want, ref = torch_want(torch, grads)
            want = digests(want)
        for name in res[0]["rec"][backend]:
            got = [r["rec"][backend][name]["digest"] for r in res]
            if name in want:
                if any(w is not None and g != w
                       for g, w in zip(got, want[name])):
                    fail(f"tree collectives: {backend} {name} differs from "
                         f"its replay in one process")
                checks[f"{backend}/{name}"] = {"check": "bit for bit"}
            if name in ref:
                holders = [i for i, r in enumerate(res)
                           if f"{backend}/{name}" in r["arrays"]]
                want_t, err = ref[name], 0.0
                for i in holders:
                    a = torch.from_numpy(
                        res[i]["arrays"][f"{backend}/{name}"]).cuda()
                    err = max(err, (a - want_t).abs().max().item())
                top = want_t.abs().max().item()
                if not holders or not math.isfinite(err) \
                        or err > TREE_REL_TOL * top:
                    fail(f"tree collectives: {backend} {name} is {err} from "
                         f"the sum in one process (max|ref| {top}, ranks "
                         f"{holders})")
                checks[f"{backend}/{name}"] = {
                    "check": f"{TREE_REL_TOL} x max|ref|" + (
                        " at the root, bit for bit elsewhere"
                        if name in want else ""),
                    "max_abs_err": err, "max_abs_ref": top,
                    "ranks_checked": holders}
            if name not in want and name not in ref:
                fail(f"tree collectives: {backend} {name} has no check")
    del grads
    # link bytes and slow-level messages against the plans
    level_of = lambda s, d: topo.levels[topo.comm_level(s, d)].name
    names = [l.name for l in topo.levels]

    def summed(name, key):
        return {k: sum(r["rec"]["p2p"][name][key][k] for r in res)
                for k in names}

    def by_level(sends):
        out = dict.fromkeys(names, 0)
        for s, d, nb in sends:
            out[level_of(s, d)] += nb
        return out

    params_nb = 2 * GPT_100M_PARAMS
    plans = {"bcast_params_3": ("bcast", 3, params_nb),
             "bcast_params_3_again": ("bcast", 3, params_nb),
             "allreduce_grad": ("allreduce", 0, 4 * GPT_100M_PARAMS)}
    for name, (op, root, nb) in plans.items():
        low = comm.plan(op, root=root, nbytes=nb).lower(nb)
        if summed(name, "link_bytes") != by_level(
                (s.src, s.dst, int(s.nbytes)) for s in low.sends):
            fail(f"tree collectives: {name} put {summed(name, 'link_bytes')}"
                 f" bytes per level, its plan sends otherwise")
    small = 4 * TREE_SMALL
    for root in TREE_ROOTS:
        edges = [(p, c) for p, cs in comm.plan("reduce", root=root)
                 .tree.children.items() for c in cs]
        for name, sends in (
                (f"reduce_{root}", [(c, p, small) for p, c in edges]),
                (f"gather_{root}",
                 [(c, p, TREE_WORLD * small) for p, c in edges]),
                (f"scatter_{root}",
                 [(p, c, TREE_WORLD * small) for p, c in edges])):
            if summed(name, "link_bytes") != by_level(sends):
                fail(f"tree collectives: {name} put "
                     f"{summed(name, 'link_bytes')} bytes per level")
    slow = {name: summed(name, "link_messages")["pod"]
            for name in ("bcast_params_3", "bcast_params_3_again")}
    crossings = comm.slow_crossings("bcast", root=3)
    if set(slow.values()) != {crossings}:
        fail(f"tree collectives: the bcasts sent {slow} slow-level messages,"
             f" the plan crosses {crossings} times")
    # the second identical bcast built no tree and hit the plan cache
    for r, got in enumerate(res):
        (h0, m0, _, _, b0), (h1, m1, _, _, b1) = got["cache"]
        if b1 != b0 or m1 != m0 or h1 != h0 + 1:
            fail(f"tree collectives: rank {r}'s repeated bcast went from "
                 f"cache {got['cache'][0]} to {got['cache'][1]}")
    want_launches = {
        "multilevel": {"quantize_int8": 0, "dequantize_int8": 0,
                       "quantize_ef_int8": 0},
        "multilevel_compress": {"quantize_int8": 1, "dequantize_int8": 1,
                                "quantize_ef_int8": 0},
        "multilevel_compress_ef": {"quantize_int8": 1, "dequantize_int8": 2,
                                   "quantize_ef_int8": 1}}
    for r, got in enumerate(res):
        if got["launches"] != want_launches:
            fail(f"tree collectives: rank {r} launched {got['launches']}, "
                 f"expected {want_launches}")
    launches = {k: sum(g["launches"]["multilevel_compress_ef"][k]
                       for g in res)
                for k in want_launches["multilevel"]}
    ops = {}
    for backend in ("p2p", "torch"):
        for name in res[0]["rec"][backend]:
            ops[f"{backend}/{name}"] = {
                "wall_ms_max_over_ranks": max(
                    r["rec"][backend][name]["ms"] for r in res),
                **checks[f"{backend}/{name}"]}
    link_bytes = {name: summed(name, "link_bytes")
                  for name in res[0]["rec"]["p2p"]}
    rec = {"world": TREE_WORLD, "backend": res[0]["backend"],
           "staging": res[0]["staging"], "phase_wall_s": wall,
           "bcast_bytes": params_nb, "allreduce_bytes": 4 * GPT_100M_PARAMS,
           "small_bytes_per_rank": small,
           "staged_bytes_per_rank": [r["staged_bytes"] for r in res],
           "link_bytes_all_ranks": link_bytes,
           "slow_messages_per_bcast": crossings,
           "plan_cache_rank0": {"before_repeat": res[0]["cache"][0],
                                "after_repeat": res[0]["cache"][1],
                                "fields": ["hits", "misses", "currsize",
                                           "maxsize", "tree_builds"]},
           "launches": launches}
    for name, op in ops.items():
        print(json.dumps({"tree_op": {"name": name, **op}}), flush=True)
    print(json.dumps({"tree_collectives": rec}), flush=True)
    return rec, [r["discovery"] for r in res]


def discovery_phase(torch, disc) -> None:
    """Phase 19's checks, from what each of the 8 ranks returned: every
    rank holds the same probe times and fits the same topology; the
    times have shape (P, P, 2), a zero diagonal and positive pairs; the
    bcast on the discovered topology is bit for bit its replay in one
    process; the second ``discover`` loaded the same topology in under
    ``DISC_LOAD_S`` seconds."""
    import numpy as np
    from repro_torch.core import Communicator
    from repro_torch.core.topology import Topology

    times = disc[0]["times"]
    P = TREE_WORLD
    if times.shape != (P, P, 2):
        fail(f"discovery: probe times of shape {times.shape}")
    off = ~np.eye(P, dtype=bool)
    if np.any(times[~off] != 0.0) or not np.all(times[off] > 0.0) \
            or not np.all(np.isfinite(times)):
        fail("discovery: probe times want a zero diagonal and positive, "
             "finite pairs")
    for r, d in enumerate(disc):
        if not np.array_equal(d["times"], times):
            fail(f"discovery: rank {r} holds other probe times than rank 0")
        if d["topo"] != disc[0]["topo"] or d["env"] != disc[0]["env"]:
            fail(f"discovery: rank {r} fitted another topology than rank 0")
        if d["again"] != d["topo"] or d["load_s"] >= DISC_LOAD_S:
            fail(f"discovery: rank {r}'s second discover took "
                 f"{d['load_s']} s and loaded "
                 f"{'the same' if d['again'] == d['topo'] else 'another'} "
                 f"topology")
    topo = Topology.from_json(disc[0]["topo"])
    env = Topology.from_json(disc[0]["env"])
    comm = Communicator(topo, policy=DISC_POLICY)
    xs = [tree_input(torch, "x", r) for r in range(P)]
    nb = xs[0].numel() * xs[0].element_size()
    want = replay_lowered(torch, xs, comm.plan(
        "bcast", root=DISC_ROOT, nbytes=nb).lower(nb))
    for r, (d, w) in enumerate(zip(disc, want)):
        if d["bcast"] != digest(w):
            fail(f"discovery: rank {r}'s bcast on the discovered topology "
                 f"differs from its replay in one process")
    stats = {}
    for k, size in enumerate(disc[0]["sizes"]):
        t = times[:, :, k][off]
        stats[f"{int(size)}B"] = {"min_us": float(t.min()) * 1e6,
                                  "median_us": float(np.median(t)) * 1e6,
                                  "max_us": float(t.max()) * 1e6}
    print(json.dumps({"discovery": {
        "ranks": P, "env_nstrata": env.nstrata,
        "env_levels": [l.name for l in env.levels],
        "probe_one_way": stats,
        "probe_s_max_over_ranks": max(d["probe_s"] for d in disc),
        "nstrata": topo.nstrata, "coords": topo.coords.tolist(),
        "levels": [{"name": l.name, "latency_us": l.latency * 1e6,
                    "bandwidth_gb_s": l.bandwidth / 1e9,
                    "overhead_us": l.overhead * 1e6} for l in topo.levels],
        "bcast_root": DISC_ROOT, "bcast_bytes": nb, "policy": DISC_POLICY,
        "bcast_plan": comm.plan("bcast", root=DISC_ROOT,
                                nbytes=nb).algorithm,
        "bcast_ms_max_over_ranks": max(d["bcast_ms"] for d in disc),
        "bcast_check": "bit for bit",
        "load_s_max_over_ranks": max(d["load_s"] for d in disc)}}),
        flush=True)


def serve_runs(serve, tmp=None, arch="gpt-100m", rows=SERVE_RUNS,
               **kw) -> list:
    """Phase 5's requests through ``serve`` on ``arch``, one call per row
    of ``rows``; with ``tmp``, each call writes its Chrome trace and
    metrics file there, and its result counts the trace's events and the
    metric series."""
    runs = []
    for n, L in rows:
        if tmp is not None:
            kw.update(trace=f"{tmp}/trace_{n}x{L}.json",
                      metrics_out=f"{tmp}/metrics_{n}x{L}.txt")
        r = serve(arch, n, L, SERVE_GEN, device="cuda", **kw)
        if tmp is not None:
            with open(kw["trace"]) as f:
                r["trace_events"] = len(json.load(f)["traceEvents"])
            with open(kw["metrics_out"]) as f:
                r["metric_series"] = sum(1 for line in f
                                         if line.startswith("# TYPE"))
        runs.append(r)
    return runs


def net_serve_phase(serve, fa, kw, plain, cfg) -> dict:
    """Phase 17, in turns with phase 5 (whose runs are ``plain``): the
    network plane twice, then phase 5 again; every turn's tokens equal
    phase 5's.  Returns the launches of the two network turns (counters
    set to 0 just before, read just after)."""
    turns = [("5", plain)]
    reset(fa, kw)
    with tempfile.TemporaryDirectory(prefix="repro_torch_serve_") as tmp:
        for _ in (1, 2):
            turns.append(("17", serve_runs(serve, tmp, mesh=NET_MESH,
                                           monitor=True)))
    net_counts = counts(fa, kw)
    turns.append(("5", serve_runs(serve)))
    for name, runs in turns[1:]:
        for r, p, (n, _) in zip(runs, plain, SERVE_RUNS):
            if not all(q.state.name == "DONE" for q in r["requests"]) \
                    or not (r["generated"] == p["generated"]).all():
                fail(f"phase {name}'s {n}-request run generated other "
                     f"tokens than phase 5's")
    prefills = sum(r["prefills"] for _, runs in turns[1:3] for r in runs)
    want = {"flash_fwd": cfg.n_layers * prefills, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "wkv": 0}
    if net_counts != want or prefills != 18:
        fail(f"serving with the network plane launched {net_counts} for "
             f"{prefills} prefills, expected {want}")
    for r, (n, L) in zip(turns[2][1], SERVE_RUNS):
        if r["setup"]["slow_crossings"] != 1:
            fail(f"the weight bcast crosses the slow link "
                 f"{r['setup']['slow_crossings']} times, the plan 1")
        snap = r["health"]
        print(json.dumps({"serve_network_plane": {
            "requests": n, "prompt": L, "mesh": NET_MESH,
            "weight_bytes": r["setup"]["weight_bytes"],
            "bcast_est_ms": r["setup"]["bcast_est_ms"],
            "slow_crossings": r["setup"]["slow_crossings"],
            "engine_demo": r["engine_demo"], "engine": r["engine"],
            "monitor_events": snap["events"], "monitor_snapshot": snap,
            "ttft_sim_p50_ms": r["report"]["ttft_p50_s"] * 1e3,
            "ttft_sim_p99_ms": r["report"]["ttft_p99_s"] * 1e3,
            "ttft_wall_p50_ms": r["ttft_wall_p50_s"] * 1e3,
            "ttft_wall_p99_ms": r["ttft_wall_p99_s"] * 1e3,
            "simulated_s": r["report"]["sim_s"],
            "tokens_per_s": r["tokens_per_s"],
            "trace_events": r["trace_events"],
            "metric_series": r["metric_series"],
            "flash_fwd_launches_two_turns": net_counts["flash_fwd"]}}),
            flush=True)
    print(json.dumps({"serve_turns": [
        {"phase": name, "wall_s": [r["seconds"] for r in runs],
         "tokens_per_s": [r["tokens_per_s"] for r in runs],
         "simulated_s": [r["report"]["sim_s"] for r in runs]}
        for name, runs in turns]}), flush=True)
    return net_counts


def bucket_train_phase(train, cfg) -> dict:
    """Phase 18: the train launcher's planning plane on the grid, with
    bucketed sync and a trace; returns the launches summed over the
    ranks."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as tmp:
        path = f"{tmp}/train_trace.json"
        bt = train("gpt-100m", device="cuda", log_every=1, trace=path,
                   **BUCKET_TRAIN)
        with open(path) as f:
            events = len(json.load(f)["traceEvents"])
    steps = BUCKET_TRAIN["steps"]
    plan = bt["plan"]
    if not all(math.isfinite(x) for x in bt["losses"]) \
            or len(bt["losses"]) != steps:
        fail(f"bucketed grid training losses {bt['losses']}")
    if not {"est_ms", "slow_crossings", "bucketed"} <= set(plan) \
            or plan["bucketed"]["n_buckets"] < 1:
        fail(f"the train launcher's planning logged {plan}")
    want = {"wkv": 0, "flash_fwd": 2 * cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps,
            "flash_bwd_dkv": cfg.n_layers * steps, "quantize_int8": 0,
            "dequantize_int8": 0, "quantize_ef_int8": 0}
    for r, got in enumerate(bt["launches"]):
        if got != want:
            fail(f"bucketed grid training rank {r} launched {got}, "
                 f"expected {want}")
    b = plan["bucketed"]
    print(json.dumps({"train_planning": {
        **BUCKET_TRAIN, "world": bt["world"], "losses": bt["losses"],
        "est_ms": plan["est_ms"], "slow_crossings": plan["slow_crossings"],
        "n_buckets": b["n_buckets"], "overlapped_ms": b["overlapped_s"] * 1e3,
        "serial_ms": b["serial_s"] * 1e3, "speedup": b["speedup"],
        "step_ms": bt["step_ms"], "trace_events": events,
        "launches_per_rank": bt["launches"]}}), flush=True)
    return {k: sum(r[k] for r in bt["launches"]) for k in want}


def elastic_case(train, name, kw, ckpt_dir, cfg) -> dict:
    """One case of phase 20 through ``train`` of ``cfg`` on the card,
    checkpointing into ``ckpt_dir``; returns its result."""
    t0 = time.perf_counter()
    out = train("gpt-100m", config=cfg, device="cuda", log_every=1,
                ckpt_dir=ckpt_dir, **kw)
    wall = time.perf_counter() - t0
    if len(out["losses"]) != ELASTIC_LOSSES[name] \
            or not all(math.isfinite(x) for x in out["losses"]):
        fail(f"phase {name}: losses {out['losses']}, expected "
             f"{ELASTIC_LOSSES[name]} finite")
    print(json.dumps({f"elastic_{name}": {
        **{k: v for k, v in kw.items() if k != "fail_at"},
        "layers": cfg.n_layers,
        "fail_at": {str(k): v for k, v in kw["fail_at"].items()},
        "wall_s": wall, "losses": out["losses"], "step_ms": out["step_ms"],
        "step_tokens": out["step_tokens"], "recovery_s": out["recovery_s"],
        "recoveries": out["recoveries"], "repairs": out["repairs"],
        "events": out["events"], "world_after": out["world"],
        "pods_after": out["pods"], "accum": out["accum"],
        "saves": [{k: v for k, v in s.items() if k != "digest"}
                  for s in out["saves"]],
        "ckpt_writes": out["ckpt_writes"],
        "launches_per_rank": out["launches"]}}), flush=True)
    return out


def ef_rows_of(path: str, step: int) -> tuple[set, int]:
    """The leading dims of a checkpoint's EF leaves, and how many EF
    leaves the manifest lists whose shape is not (rows,) + the shape of
    the parameter leaf of the same path."""
    with open(f"{path}/step_{step:09d}/manifest.json") as f:
        leaves = json.load(f)["leaves"]
    rows, bad = set(), 0
    for fn, meta in leaves.items():
        if fn.startswith("opt_ef_"):
            p = leaves["params_" + fn[len("opt_ef_"):]]["shape"]
            rows.add(meta["shape"][0])
            bad += meta["shape"][1:] != p
    return rows, bad


def elastic_answer(train, get_config) -> None:
    """Phase 20c: 2 layers of gpt-100m at full width, f32, on four ranks
    on the card and on four gloo ranks on the CPU from the same weights,
    pod 1 failing before step 2: the losses agree."""
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import stack_runs, to_numpy
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("gpt-100m"), n_layers=2,
                              pattern=("attn",) * 2)
    params = to_numpy(stack_runs(tree_map(lambda t: t.float(), T.init_model(
        cfg, seed=0, device="cpu")), cfg))
    runs, wall = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = train("gpt-100m", config=cfg, init_params=params,
                          device=dev, log_every=100, **ELASTIC_ANSWER)
        wall[dev] = time.perf_counter() - t0
    l_gpu, l_cpu = runs["cuda"]["losses"], runs["cpu"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    print(json.dumps({"elastic_20c_f32_card_vs_cpu": {
        **{k: v for k, v in ELASTIC_ANSWER.items() if k != "fail_at"},
        "fail_at": {str(k): v for k, v in ELASTIC_ANSWER["fail_at"].items()},
        "layers": 2, "losses_card": l_gpu, "losses_cpu": l_cpu,
        "repairs": [runs[d]["repairs"] for d in ("cuda", "cpu")],
        "max_rel_loss_diff": rel, "loss_tolerance": GRID_LOSS_TOL,
        "wall_s_card": wall["cuda"], "wall_s_cpu": wall["cpu"]}}),
        flush=True)
    if len(l_gpu) != len(l_cpu) or len(l_gpu) != ELASTIC_ANSWER["steps"] \
            or any(runs[d]["repairs"] != 1 for d in runs):
        fail(f"phase 20c: {len(l_gpu)} losses on the card, {len(l_cpu)} on "
             f"the CPU, repairs {[runs[d]['repairs'] for d in runs]}")
    if not math.isfinite(rel) or rel > GRID_LOSS_TOL:
        fail(f"phase 20c: the f32 losses through a failure differ by {rel} "
             f"(relative) between card and CPU")


def elastic_phase(train, get_config) -> dict:
    """Phase 20: elastic training of gpt-100m at full width, cut to
    ELASTIC_LAYERS layers, on ranks sharing the card.  20a repairs in
    place and checkpoints from the shrunk grid; 20b restarts below quorum
    from a checkpoint, whose restored state must equal, bit for bit, the
    state gathered at its save; 20c holds the losses through a failure to
    the CPU's.  Returns the launches of 20a and 20b summed over their
    surviving ranks."""
    t_phase = time.perf_counter()
    cfg = cut(get_config, "gpt-100m", ELASTIC_LAYERS)
    with tempfile.TemporaryDirectory(prefix="repro_torch_elastic_") as tmp:
        a = elastic_case(train, "20a", ELASTIC_REPAIR, f"{tmp}/a", cfg)
        leaves, steps = 10, ELASTIC_REPAIR["steps"]
        want = {"wkv": 0, "flash_fwd": 2 * cfg.n_layers * steps,
                "flash_bwd_dq": cfg.n_layers * steps,
                "flash_bwd_dkv": cfg.n_layers * steps, "quantize_int8": 0,
                "dequantize_int8": leaves * steps,
                "quantize_ef_int8": leaves * steps}
        seq, rows = ELASTIC_REPAIR["seq"], ELASTIC_REPAIR["batch"]
        if a["repairs"] != 1 or a["recoveries"] != 0 \
                or [e["event"] for e in a["events"]] != ["failure", "repair"] \
                or a["events"][1]["survivors"] != 3 or a["world"] != 3:
            fail(f"phase 20a: repairs {a['repairs']}, recoveries "
                 f"{a['recoveries']}, events {a['events']}")
        if a["step_tokens"] != [rows * seq] * 2 + [rows // 3 * 3 * seq] * 4:
            fail(f"phase 20a: tokens a step {a['step_tokens']}")
        if [(s["step"], s["pods"]) for s in a["saves"]] != [(3, 3)] \
                or ef_rows_of(f"{tmp}/a", 3) != ({3}, 0):
            fail(f"phase 20a: saves {a['saves']}; the EF leaves of step 3 "
                 f"lead with {ef_rows_of(f'{tmp}/a', 3)}")
        if len(a["launches"]) != 3 or any(r != want for r in a["launches"]):
            fail(f"phase 20a: the surviving ranks launched {a['launches']}, "
                 f"expected {want} each")
        shutil.rmtree(f"{tmp}/a")

        b = elastic_case(train, "20b", ELASTIC_RESTART, f"{tmp}/b", cfg)
        saved = {s["step"]: s["digest"] for s in b["saves"]}
        if b["recoveries"] != 1 or b["repairs"] != 0 or b["accum"] != 2 \
                or b["pods"] != 1 or b["world"] != 2 \
                or [e["in_place"] for e in b["events"]] != [False]:
            fail(f"phase 20b: recoveries {b['recoveries']}, repairs "
                 f"{b['repairs']}, accum {b['accum']}, grid {b['pods']} "
                 f"pods of {b['world']} ranks")
        if [r["step"] for r in b["restored"]] != [6] \
                or b["restored"][0]["digest"] != saved.get(6):
            fail(f"phase 20b: restored {b['restored']}, saved {saved}")
        print(json.dumps({"elastic_20b_restore": {
            "step": 6, "digest_saved": saved[6],
            "digest_restored": b["restored"][0]["digest"],
            "check": "bit for bit"}}), flush=True)
    elastic_answer(train, get_config)
    print(json.dumps({"elastic_phase_wall_s": time.perf_counter() - t_phase}),
          flush=True)
    return {k: sum(r[k] for r in a["launches"] + b["launches"])
            for k in a["launches"][0]}


def tp_elastic_phase(train, get_config) -> dict:
    """Phase 30: ``TP_ELASTIC`` through ``train`` on the card (six spawned
    ranks, fresh processes whose counters start at 0 and are read at
    their end).  Returns the launches summed over the two surviving
    ranks."""
    cfg = cut(get_config, "gpt-100m", TP_ELASTIC_LAYERS)
    kw = TP_ELASTIC
    with tempfile.TemporaryDirectory(prefix="repro_torch_tp_elastic_") as tmp:
        t0 = time.perf_counter()
        out = train("gpt-100m", config=cfg, device="cuda", log_every=1,
                    ckpt_dir=tmp, **kw)
        wall = time.perf_counter() - t0
        ef = {s: ef_rows_of(tmp, s) for s, _ in TP_ELASTIC_SAVES}
    saved = {s["step"]: s["digest"] for s in out["saves"]}
    rows, seq, n, leaves = kw["batch"], kw["seq"], cfg.n_layers, 10
    micro = TP_ELASTIC_MICRO
    want = {"wkv": 0, "flash_fwd": 2 * n * micro, "flash_bwd_dq": n * micro,
            "flash_bwd_dkv": n * micro, "quantize_int8": 0,
            "dequantize_int8": leaves * TP_ELASTIC_SLOW,
            "quantize_ef_int8": leaves * TP_ELASTIC_SLOW}
    print(json.dumps({"tp_elastic_30a": {
        **{k: v for k, v in kw.items() if k != "fail_at"},
        "fail_at": {str(k): v for k, v in kw["fail_at"].items()},
        "layers": n, "wall_s_with_spawn": wall, "losses": out["losses"],
        "step_ms": out["step_ms"], "step_tokens": out["step_tokens"],
        "recovery_s": out["recovery_s"], "events": out["events"],
        **{k: out[k] for k in TP_ELASTIC_WANT},
        "saves": [{k: v for k, v in s.items() if k != "digest"}
                  for s in out["saves"]],
        "ckpt_writes": out["ckpt_writes"], "ef_rows": {
            str(s): sorted(r) for s, (r, _) in ef.items()},
        "staged_bytes_per_step": out["staged_bytes"],
        "tp_calls_per_rank": out["tp_calls_ranks"],
        "peak_mem_bytes_per_rank": out["peak_mem_bytes"],
        "launches_per_rank": out["launches"]}}), flush=True)
    got = {k: out[k] for k in TP_ELASTIC_WANT}
    events = [(e["event"], e.get("in_place", e.get("survivors")))
              for e in out["events"]]
    if events != TP_ELASTIC_EVENTS or got != TP_ELASTIC_WANT:
        fail(f"phase 30a: events {out['events']}, {got}; expected "
             f"{TP_ELASTIC_EVENTS}, {TP_ELASTIC_WANT}")
    if len(out["losses"]) != 7 \
            or not all(math.isfinite(x) for x in out["losses"]) \
            or out["step_tokens"] != [rows * seq] * 4 + [2 * rows * seq] * 3:
        fail(f"phase 30a: losses {out['losses']}, tokens a step "
             f"{out['step_tokens']}")
    if [(s["step"], s["pods"]) for s in out["saves"]] != TP_ELASTIC_SAVES \
            or any(ef[s] != ({p}, 0) for s, p in TP_ELASTIC_SAVES):
        fail(f"phase 30a: saves {out['saves']}; the EF leaves lead with "
             f"{ef}")
    if out["restored"] != [{"step": 2, "digest": saved.get(2)}]:
        fail(f"phase 30a: restored {out['restored']}, saved {saved}")
    print(json.dumps({"tp_elastic_30a_restore": {
        "step": 2, "digest_saved": saved[2],
        "digest_restored": out["restored"][0]["digest"],
        "check": "bit for bit"}}), flush=True)
    ranks = out["tp_calls_ranks"]
    if len(ranks) != 2 or ranks[0] != ranks[1] or len(ranks[0]) != 7 \
            or min(ranks[0][0].values()) < 1:
        fail(f"phase 30a: the survivors' model-axis collectives a step "
             f"{ranks}")
    if len(out["launches"]) != 2 or any(r != want for r in out["launches"]):
        fail(f"phase 30a: the surviving ranks launched {out['launches']}, "
             f"expected {want} each")
    return {k: sum(r[k] for r in out["launches"]) for k in want}


def cut(get_config, arch, n):
    """``arch`` at full width, cut to its first ``n`` layers (encoder and
    decoder each for enc-dec; None keeps them all)."""
    cfg = get_config(arch)
    if n is None:
        return cfg
    enc = cfg.enc_dec and dataclasses.replace(
        cfg.enc_dec, n_enc_layers=n, n_dec_layers=n)
    return dataclasses.replace(cfg, n_layers=n, pattern=cfg.pattern[:n],
                               enc_dec=enc)


def flash_per_prefill(cfg) -> int:
    """Flash-forward launches of one prefill: each attention layer, and
    for enc-dec each encoder layer and each decoder layer's cross
    attention."""
    n = sum(k in ("attn", "local") for k in cfg.pattern)
    return n + (cfg.enc_dec.n_enc_layers + n if cfg.enc_dec else 0)


def ranged(torch, label, fn):
    """``fn`` inside a profiler range named ``label``."""
    def run(*args):
        with torch.profiler.record_function(label):
            return fn(*args)
    return run


def moe_profile(torch, T, L, cfg, params) -> dict:
    """One 8 x 512 prefill of the MoE model under torch.profiler: the
    card's ms in flash, in the expert products (``_moe_experts``), in the
    router, top-k, sort and group-size read (``_moe_route``), and in
    everything else; beside them the host ms of the route, which waits
    for the group sizes, and the prefill's wall ms."""
    B, S = MOE_PROFILE
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(B)).cuda()
    run = lambda: T.prefill(params, cfg, {"tokens": toks}, S)
    run()
    torch.cuda.synchronize()
    orig = (L._moe_route, L._moe_experts)
    P = torch.profiler.ProfilerActivity
    syncs = L.moe_fwd.host_syncs
    try:
        L._moe_route = ranged(torch, "moe_route", orig[0])
        L._moe_experts = ranged(torch, "moe_experts", orig[1])
        with torch.profiler.profile(activities=[P.CPU, P.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        L._moe_route, L._moe_experts = orig
    syncs = L.moe_fwd.host_syncs - syncs
    cuda = torch.autograd.DeviceType.CUDA
    labels = ("moe_route", "moe_experts")
    # the ranges' own spans on the card's timeline are not kernels
    kerns = [e for e in prof.key_averages()
             if e.device_type == cuda and e.key not in labels]
    total = sum(e.self_device_time_total for e in kerns) / 1e3
    flash = sum(e.self_device_time_total for e in kerns
                if "flash_fwd" in e.key) / 1e3
    ranges = {}
    for e in prof.events():
        if e.name in labels and e.device_type != cuda:
            dev_ms, host_ms = ranges.get(e.name, (0.0, 0.0))
            ranges[e.name] = (dev_ms + e.device_time_total / 1e3,
                              host_ms + e.cpu_time_total / 1e3)
    route, experts = ranges.get("moe_route"), ranges.get("moe_experts")
    if route is None or experts is None \
            or not flash + experts[0] + route[0] <= total:
        fail(f"the MoE prefill's profile does not attribute its device "
             f"time: total {total} ms, flash {flash} ms, ranges {ranges}")
    rec = {"batch": B, "prompt": S, "wall_ms": wall * 1e3,
           "device_ms": total, "flash_ms": flash,
           "expert_products_ms": experts[0], "router_sort_ms": route[0],
           "other_ms": total - flash - experts[0] - route[0],
           "idle_share": 1.0 - total / (wall * 1e3),
           "router_sort_host_ms": route[1],
           "expert_products_host_ms": experts[1], "host_syncs": syncs}
    print(json.dumps({"moe_prefill_profile": rec}), flush=True)
    return rec


def moe_serve_phase(torch, serve, fa, kw, T, L, get_config) -> dict:
    """Phase 21: olmoe-1b-7b at full width and depth through ``serve``,
    phase 5's requests, the counters and the MoE's host syncs set to 0
    just before and read just after; then one profiled 8 x 512 prefill.
    Returns the launches."""
    cfg = get_config(MOE_ARCH)
    reset(fa, kw)
    L.moe_fwd.host_syncs = 0
    t0 = time.perf_counter()
    runs = serve_runs(serve, arch=MOE_ARCH)
    wall = time.perf_counter() - t0
    got, syncs = counts(fa, kw), L.moe_fwd.host_syncs
    prefills = sum(r["prefills"] for r in runs)
    for r, (n, _) in zip(runs, SERVE_RUNS):
        if not all(q.state.name == "DONE" for q in r["requests"]):
            fail(f"{MOE_ARCH}: a request did not finish")
        gen = r["generated"]
        if gen.shape != (n, SERVE_GEN) or gen.min() < 0 \
                or gen.max() >= cfg.vocab:
            fail(f"{MOE_ARCH} generated tokens of shape {gen.shape} out of "
                 f"range")
    want = {"flash_fwd": cfg.n_layers * prefills, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "wkv": 0}
    if got != want or prefills != 9:
        fail(f"{MOE_ARCH} serving launched {got} for {prefills} prefills, "
             f"expected {want}")
    steps = sum(r["report"]["steps"] for r in runs)
    for r, (n, L_) in zip(runs, SERVE_RUNS):
        print(json.dumps({"moe_serve": {
            "arch": MOE_ARCH, "requests": n, "prompt": L_,
            "generated": SERVE_GEN, "wall_s": r["seconds"],
            "tokens_per_s": r["tokens_per_s"],
            "ttft_wall_p50_ms": r["ttft_wall_p50_s"] * 1e3,
            "ttft_wall_p99_ms": r["ttft_wall_p99_s"] * 1e3,
            "steps": r["report"]["steps"],
            "simulated_s": r["report"]["sim_s"]}}), flush=True)
    print(json.dumps({"moe_serve_phase": {
        "launches": got, "prefills": prefills, "scheduler_steps": steps,
        "host_syncs": syncs, "host_syncs_per_step": syncs / steps,
        "wall_s_with_init": wall}}), flush=True)
    kept = [{"generated": r["generated"], "first_logits": r["first_logits"]}
            for r in runs]
    del runs
    params = T.init_model(cfg, seed=0, device="cuda")
    moe_profile(torch, T, L, cfg, params)
    del params
    torch.cuda.empty_cache()
    return got, kept


def dense_serve_phase(torch, fa, kw, T, get_config) -> int:
    """Phase 22: the four configs the paged scheduler refuses or that
    carry a prefix, at full width, on the dense path: each prefill and 16
    greedy tokens, the counters set to 0 just before each config and read
    just after.  Returns the flash launches."""
    from repro_torch.tree import tree_leaves

    total = 0
    for arch, depth, prefills, P in DENSE_SERVE:
        cfg = cut(get_config, arch, depth)
        params = T.init_model(cfg, seed=0, device="cuda")
        reset(fa, kw)
        runs = [dense_serve(torch, cfg, params, B, L_, P)
                for B, L_ in prefills]
        got = counts(fa, kw)
        want = {"flash_fwd": flash_per_prefill(cfg) * len(prefills),
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "wkv": 0}
        if got != want:
            fail(f"{arch} on the dense path launched {got}, expected {want}")
        for (B, L_), r in zip(prefills, runs):
            gen = r["tokens"]
            if gen.shape != (B, DENSE_GEN) or gen.min() < 0 \
                    or gen.max() >= cfg.vocab \
                    or not all(torch.isfinite(x).all() for x in r["logits"]):
                fail(f"{arch} served tokens of shape {tuple(gen.shape)} or "
                     f"non-finite logits")
            print(json.dumps({"dense_serve": {
                "arch": arch, "layers": cfg.n_layers,
                "params": sum(t.numel() for t in tree_leaves(params)),
                "batch": B, "prompt": L_, "prefix": P,
                "generated": DENSE_GEN, "prefill_wall_ms": r["prefill_ms"],
                "decode_wall_ms_per_step": r["decode_ms_per_step"],
                "tokens_per_s": B * DENSE_GEN / r["wall_s"],
                "flash_fwd_launches": got["flash_fwd"]}}), flush=True)
        total += got["flash_fwd"]
        del params, runs
        torch.cuda.empty_cache()
    return total


def routing_diff(card, cpu, k) -> tuple[int, int]:
    """(tokens whose top-k experts differ between the card's and the
    CPU's routing of one MoE call, of those the near-ties)."""
    (ig, _), (ic, vc) = card, cpu
    differ = (ig[:, :k].sort(-1).values != ic[:, :k].sort(-1).values) \
        .any(-1)
    tie = (vc[:, k - 1] - vc[:, k]) <= NEAR_TIE
    return int(differ.sum()), int((differ & tie).sum())


def arch_answer(torch, T, L, get_config) -> dict:
    """Phase 23: each new config at full width and one pattern period in
    f32 on the card and on the CPU: the prefill's logits and cache, then
    ANSWER_STEPS decode steps, each from the CPU's cache and token on both
    sides; every MoE call's routing compared token by token."""
    from repro_torch.launch.step import make_decode_fn, make_prefill_fn
    from repro_torch.tree import tree_map

    out = {}
    B, L_, P_ = ANSWER_INPUT
    orig = L._moe_route
    routes = {"cpu": [], "cuda": []}

    def recording(p, m, xt):
        probs = torch.softmax(xt.float() @ p["router"].float(), -1)
        top = torch.topk(probs, m.top_k + 1, dim=-1)
        routes[xt.device.type].append((top.indices.cpu(), top.values.cpu()))
        return orig(p, m, xt)

    for arch, n in ANSWER_LAYERS.items():
        cfg = cut(get_config, arch, n)
        P = P_ if cfg.frontend else 0
        p_gpu = tree_map(lambda t: t.float(),
                         T.init_model(cfg, seed=0, device="cuda"))
        p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
        inputs = prompt_inputs(torch, cfg, B, L_, P, 23)
        s_max = (0 if cfg.enc_dec else P) + L_ + ANSWER_STEPS
        prefill, decode = make_prefill_fn(cfg, s_max), make_decode_fn(cfg)
        for r in routes.values():
            r.clear()
        L._moe_route = recording
        try:
            lg_c, cache_c, pos = prefill(p_cpu, inputs)
            lg_g, cache_g, _ = prefill(p_gpu, {k: v.cuda()
                                               for k, v in inputs.items()})
            rec, ok = {"layers": cfg.n_layers, "steps": []}, True
            for i in range(ANSWER_STEPS + 1):
                if i:
                    tok = lg_c[:, -1].argmax(-1, keepdim=True)
                    start = tree_map(lambda t: t.cuda(), cache_c)
                    lg_c, cache_c = decode(p_cpu, cache_c, tok, pos + i - 1)
                    lg_g, cache_g = decode(p_gpu, start, tok.cuda(),
                                           pos + i - 1)
                err = (lg_g.cpu() - lg_c).abs().max().item() \
                    / max(1.0, lg_c.abs().max().item())
                step = {"logits_max_rel_err": err}
                ok = err <= ARCH_TOL
                for r, (eg, ec) in enumerate(zip(cache_g, cache_c)):
                    for name in ec:
                        e, leaf_ok = leaf_errs(torch, eg[name], ec[name])
                        step[f"run{r}_{name}"] = e
                        ok &= leaf_ok
                rec["steps"].append(step)
                if not ok:
                    fail(f"{arch} f32 {'prefill' if not i else f'step {i}'} "
                         f"on the card differs from the CPU: {step}")
        finally:
            L._moe_route = orig
        if cfg.moe:
            k = cfg.moe.top_k
            if len(routes["cuda"]) != len(routes["cpu"]):
                fail(f"{arch}: {len(routes['cuda'])} MoE calls on the card, "
                     f"{len(routes['cpu'])} on the CPU")
            per_layer = [[0, 0] for _ in range(cfg.n_layers)]
            for j, (g, c) in enumerate(zip(routes["cuda"], routes["cpu"])):
                d, t = routing_diff(g, c, k)
                per_layer[j % cfg.n_layers][0] += d
                per_layer[j % cfg.n_layers][1] += t
            rec["routing_differing_tokens_per_layer"] = [x[0]
                                                         for x in per_layer]
            rec["routing_near_ties_per_layer"] = [x[1] for x in per_layer]
            rec["routed_tokens_per_layer"] = sum(
                c[0].shape[0] for c in routes["cpu"]) // cfg.n_layers
            if any(d != t for d, t in per_layer):
                fail(f"{arch}: tokens routed to other experts on the card "
                     f"than on the CPU without a near-tie: {per_layer}")
        print(json.dumps({"arch_f32_card_vs_cpu": {
            "arch": arch, "batch": B, "prompt": L_, "prefix": P,
            "tolerance": ARCH_TOL, **rec}}), flush=True)
        out[arch] = rec
        del p_gpu, p_cpu, cache_c, cache_g
        torch.cuda.empty_cache()
    return out


def tp_serve_phase(serve, arch, mesh, plain, cfg) -> int:
    """Phase 24a/24b: ``serve`` of ``arch`` at full width on ``mesh``, the
    M ranks of one model group sharing the card over gloo, phase 5's
    batch (TP_SERVE_RUNS), against the one-rank run ``plain`` of it
    (phase 5's or 21's): every request done, tokens in range, the first
    prefill's bf16 logits within LOGIT_TOL of the one-rank run's, each
    rank's flash launches (each rank is a fresh process whose counter
    starts at 0: one a layer and prefill, on its heads).  Printed beside
    them: wall s, tok/s, wall TTFT, the model axis's collectives a prefill
    and a decode step, the bytes each rank staged through host memory, the
    MoE's dropped slots per layer, the token agreement with the one-rank
    run.  Returns the flash launches of every rank."""
    launches = 0
    t0 = time.perf_counter()
    runs = serve_runs(serve, arch=arch, rows=TP_SERVE_RUNS, mesh=mesh)
    wall = time.perf_counter() - t0
    for r, p, (n, L_) in zip(runs, plain, TP_SERVE_RUNS):
        gen = r["generated"]
        if not all(q.state.name == "DONE" for q in r["requests"]) \
                or gen.shape != (n, SERVE_GEN) or gen.min() < 0 \
                or gen.max() >= cfg.vocab:
            fail(f"{arch} on {mesh}: a request did not finish, or tokens "
                 f"of shape {gen.shape} out of range")
        ax = r["model_axis"]
        err = float(abs(r["first_logits"] - p["first_logits"]).max())
        rec = {"arch": arch, "mesh": mesh, "requests": n, "prompt": L_,
               "generated": SERVE_GEN, "wall_s": r["seconds"],
               "tokens_per_s": r["tokens_per_s"],
               "ttft_wall_p50_ms": r["ttft_wall_p50_s"] * 1e3,
               "ttft_wall_p99_ms": r["ttft_wall_p99_s"] * 1e3,
               "first_prefill_max_abs_logit_err_bf16": err,
               "logit_tol": LOGIT_TOL,
               "token_agreement": float((gen == p["generated"]).mean()),
               **{k: ax[k] for k in (
                   "collectives_per_prefill", "collectives_per_decode_step",
                   "staged_bytes", "flash_fwd_launches",
                   "moe_dropped_per_layer", "moe_dropped_first_prefill")},
               "wall_s_with_spawn": wall}
        print(json.dumps({"tp_serve": rec}), flush=True)
        if ax["flash_fwd_launches"] != [cfg.n_layers * r["prefills"]] \
                * ax["model"]:
            fail(f"{arch} on {mesh}: flash launches per rank "
                 f"{ax['flash_fwd_launches']} for {r['prefills']} prefills")
        if not err <= LOGIT_TOL:
            fail(f"{arch} on {mesh}: first prefill's logits {err} from the "
                 f"one-rank run's")
        launches += sum(ax["flash_fwd_launches"])
    return launches


def tp_dense_rank(rank, mesh, arch, n, prefills, P=0, gen=DENSE_GEN,
                  f32_first=False, members=None, align=8):
    """One rank of phase 24c (and 28a-b, 29a, 31a): ``arch`` cut to ``n``
    layers at full width, this rank's shard on ``mesh``'s model axis
    (gloo, the card shared), the dense path's prefills (after ``P`` prefix
    positions or encoder frames) and ``gen`` greedy tokens, with the
    sequence-parallel decode; the flash and WKV counters set to 0 just
    before the prefills and read just after.  ``f32_first``: then the
    same shard in f32, the first prompt's prefill logits
    (``f32_first_logits``), uncounted.  ``members``: the ranks of the
    grid, where they are not all (``make_grid``); ``align``: what the
    cache's length is rounded up to a multiple of.  Also returns the
    process's peak memory over the prefills and the slots a MoE's
    expert-parallel block dropped."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv as kw
    from repro_torch.launch.mesh import make_grid, parse_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    model = parse_mesh(mesh)[2]
    grid = make_grid(1, 1, dev, model=model, members=members)
    cfg = cut(get_config, arch, n)
    params = T.init_model(cfg, seed=0, device=dev, model=model,
                          m=grid.tp.index)
    reset(fa, kw)
    torch.cuda.reset_peak_memory_stats(dev)
    out = []
    L.moe_fwd.dropped = dropped = []
    for B, L_ in prefills:
        s0 = grid.staged_bytes
        r = dense_serve(torch, cfg, params, B, L_, P, grid=grid, align=align,
                        gen=gen)
        out.append({"tokens": r["tokens"].cpu().numpy(),
                    "first_logits": r["logits"][0].cpu().numpy(),
                    "finite": all(bool(torch.isfinite(x).all())
                                  for x in r["logits"]),
                    "staged_bytes": grid.staged_bytes - s0,
                    **{k: r[k] for k in (
                        "prefill_ms", "decode_ms_per_step", "wall_s",
                        "collectives_prefill",
                        "collectives_per_decode_step")}})
    L.moe_fwd.dropped = None
    got = counts(fa, kw)
    res = {"runs": out, "flash_fwd": got["flash_fwd"], "wkv": got["wkv"],
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "dropped": dropped}
    if f32_first:
        from repro_torch.launch.step import make_prefill_fn
        from repro_torch.tree import tree_map

        params = tree_map(lambda t: t.float(), params)
        B, L_ = prefills[0]
        ins = {k: v.cuda()
               for k, v in prompt_inputs(torch, cfg, B, L_, P, L_).items()}
        s_max = L_ + gen - 1
        lg, _, _ = make_prefill_fn(cfg, s_max + (-s_max) % align, grid)(
            params, ins)
        res["f32_first_logits"] = lg.float().cpu().numpy()
        del params
        torch.cuda.empty_cache()
    return res


def tp_dense_phase(torch, T, get_config, ranks) -> int:
    """Phase 24c: the dense path on the model axis, each rank's cache
    split over the sequence (the windowed layers' 1024-slot ring wraps
    under the 2048-token prompt; ``ranks``: each rank's ``tp_dense_rank``
    result, from the spawn of ``tp_rs_rank``): against the one-rank dense
    path in this process on the same weights, the first prefill's bf16
    logits within LOGIT_TOL and the token agreement.  Returns the flash
    launches of every rank."""
    arch, n, mesh, prefills = TP_DENSE
    cfg = cut(get_config, arch, n)
    params = T.init_model(cfg, seed=0, device="cuda")
    one = [dense_serve(torch, cfg, params, B, L_, align=8)
           for B, L_ in prefills]
    del params
    torch.cuda.empty_cache()
    for i, ((B, L_), o) in enumerate(zip(prefills, one)):
        r = ranks[0]["runs"][i]
        want = o["logits"][0].cpu().numpy()
        err = float(abs(r["first_logits"] - want).max())
        gen = r["tokens"]
        for other in ranks[1:]:
            if not (other["runs"][i]["tokens"] == gen).all():
                fail(f"{arch} on {mesh}: the ranks took other tokens")
        print(json.dumps({"tp_dense": {
            "arch": arch, "layers": cfg.n_layers, "mesh": mesh, "batch": B,
            "prompt": L_, "generated": DENSE_GEN,
            "prefill_wall_ms": r["prefill_ms"],
            "decode_wall_ms_per_step": r["decode_ms_per_step"],
            "tokens_per_s": B * DENSE_GEN / r["wall_s"],
            "one_rank_prefill_wall_ms": o["prefill_ms"],
            "one_rank_decode_wall_ms_per_step": o["decode_ms_per_step"],
            "collectives_prefill": r["collectives_prefill"],
            "collectives_per_decode_step": r["collectives_per_decode_step"],
            "staged_bytes": [x["runs"][i]["staged_bytes"] for x in ranks],
            "first_prefill_max_abs_logit_err_bf16": err,
            "logit_tol": LOGIT_TOL,
            "token_agreement": float(
                (gen == o["tokens"].cpu().numpy()).mean()),
            "flash_fwd_launches": [x["flash_fwd"] for x in ranks]}}),
            flush=True)
        if not r["finite"] or gen.shape != (B, DENSE_GEN) \
                or gen.min() < 0 or gen.max() >= cfg.vocab:
            fail(f"{arch} on {mesh}: tokens of shape {gen.shape} or "
                 f"non-finite logits")
        if not err <= LOGIT_TOL:
            fail(f"{arch} on {mesh}: first prefill's logits {err} from the "
                 f"one-rank run's")
    want = flash_per_prefill(cfg) * len(prefills)
    if any(x["flash_fwd"] != want for x in ranks):
        fail(f"{arch} on {mesh}: flash launches "
             f"{[x['flash_fwd'] for x in ranks]}, expected {want} a rank")
    return sum(x["flash_fwd"] for x in ranks)


def tp_answer_inputs(torch, cfg):
    """Phase 24d's inputs: a right-padded prompt for the paged prefill and
    a batch for the dense path, from a seed."""
    B, L_, pad = TP_ANSWER_INPUT
    gen = torch.Generator().manual_seed(24)
    return {"paged": torch.randint(0, cfg.vocab, (1, L_ + pad),
                                   generator=gen),
            "dense": torch.randint(0, cfg.vocab, (B, L_), generator=gen),
            "steps": torch.randint(0, cfg.vocab, (TP_ANSWER_STEPS, B, 1),
                                   generator=gen)}


def tp_answer_cfg(get_config, arch, model):
    """``arch`` at full width and its smoke config's depth; an MoE with
    room for every slot (capacity_factor M), so that the expert-parallel
    block computes what the one-rank dense block does."""
    cfg = cut(get_config, arch, get_config(arch, smoke=True).n_layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(model)))
    return cfg


def host_state(state):
    """A one-rank cache or pool list copied to the host (f32 numpy; a
    copy even of a host tensor, which a decode step may write in place)."""
    return [{k: v.float().cpu().numpy().copy() for k, v in e.items()}
            for e in state]


def cut_state(torch, full, state, tp, cfg):
    """This rank's part of ``full`` (a one-rank ``host_state``) in the
    layout of ``state``, this rank's cache or pools (its KV heads from the
    first that its query heads read)."""
    from repro_torch.models import layers as L

    first = L.heads(cfg, tp).kv0
    return [{k: tp_cut(torch, full[r][k], v, tp, first if k in
                       ("k", "v", "xk", "xv") else None)
             for k, v in e.items()} for r, e in enumerate(state)]


def dense_answer_paths(torch, T, cfg, params, ins, steps, s_max, tp=None,
                       before=None):
    """The dense path of 24d, 28d and 29c: the prefill's logits and those of a
    decode step for each of ``steps`` (fixed tokens).  Each step starts
    from ``before[i]``, the one-rank cache of that step cut for this rank,
    where given; the one-rank run records them in ``out["before"]``."""
    lg, cache, S = T.prefill(params, cfg, ins, s_max, tp=tp)
    out = {"prefill": lg, "steps": [], "before": []}
    for i, t in enumerate(steps):
        if before is None:
            out["before"].append(host_state(cache))
        else:
            cache = cut_state(torch, before[i], cache, tp, cfg)
        lg, cache = T.decode_step(params, cfg, cache, t, S + i, tp=tp,
                                  s_max=s_max)
        out["steps"].append(lg)
    return out


def tp_answer_paths(torch, T, cfg, params, ins, tp=None, before=None):
    """The paged prefill's logits and TP_ANSWER_STEPS paged decode steps'
    (the prefill's cache scattered into pools of this rank's KV heads),
    then ``dense_answer_paths``'.  Each paged step starts from
    ``before["pools"][i]``, the one-rank run's pools of that step cut for
    this rank, where given; the one-rank run records its pools and cache
    in ``out["before"]``."""
    B, L_, pad = TP_ANSWER_INPUT
    out = {"before": {"pools": []}}
    lg, cache, _ = T.prefill(params, cfg, {"tokens": ins["paged"].cuda()},
                             L_ + pad, last_pos=torch.tensor([L_ - 1]).cuda(),
                             full_local_cache=True, tp=tp, seq_shard=False)
    out["paged_prefill"] = lg.cpu().numpy()
    nb = (L_ + pad) // TP_ANSWER_BLOCK
    pools = T.init_paged_pools(cfg, 1 + nb, TP_ANSWER_BLOCK, device="cuda",
                               tp=tp)
    T.scatter_prefill_cache(pools, cache, list(range(1, nb + 1)),
                            TP_ANSWER_BLOCK)
    tables = torch.arange(1, nb + 1, device="cuda")[None]
    out["paged_steps"] = []
    for i in range(TP_ANSWER_STEPS):
        if before is None:
            out["before"]["pools"].append(host_state(pools))
        else:
            pools = cut_state(torch, before["pools"][i], pools, tp, cfg)
        lg, pools = T.decode_step_paged(
            params, cfg, pools, tables, ins["steps"][i][:1].cuda(),
            torch.tensor([L_ + i]).cuda(), tp=tp)
        out["paged_steps"].append(lg.cpu().numpy())
    s_max = L_ + TP_ANSWER_STEPS
    s_max += (-s_max) % 8
    dense = dense_answer_paths(
        torch, T, cfg, params, {"tokens": ins["dense"].cuda()},
        ins["steps"].cuda(), s_max, tp,
        None if before is None else before["cache"])
    out["before"]["cache"] = dense["before"]
    out["dense_prefill"] = dense["prefill"].cpu().numpy()
    out["dense_steps"] = [lg.cpu().numpy() for lg in dense["steps"]]
    return out


def tp_cut(torch, full, like, tp, first=None):
    """This rank's part of a one-rank cache or pool leaf ``full`` (numpy)
    in the layout of ``like``, a copy on its device: cut along the one
    dim where they differ (the sequence where ``like`` holds every KV
    head, else the KV heads, from ``first`` where given; RWKV-6's
    heads), or whole (RWKV-6's carried rows)."""
    t = torch.as_tensor(full).to(device=like.device, dtype=like.dtype)
    dims = [d for d in range(t.dim()) if t.shape[d] != like.shape[d]]
    if not dims:
        return t.clone()
    n = like.shape[dims[0]]
    start = first if first is not None and dims[0] == 3 else tp.index * n
    return t.narrow(dims[0], start, n).contiguous()


def tp_answer_rank(rank, jobs):
    """One of the 4 ranks of phase 24d (one spawn): for each ``(model,
    archs, befores)`` of ``jobs``, a (1 x 4/model x model) grid whose
    first model group runs ``tp_answer_on``; results under the model
    size (the other groups' None)."""
    import torch
    from repro_torch.launch.mesh import make_grid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {}
    for model, archs, befores in jobs:
        grid = make_grid(1, 4 // model, dev, model=model)
        out[model] = tp_answer_on(grid.tp, dev, model, rank % model, archs,
                                  befores) if grid.rank == 0 else None
    return out


def tp_answer_on(tp, dev, model, m, archs, befores):
    """Rank ``m`` of the model axis ``tp``: f32 weights of each of
    ``archs``, this rank's shard, the paths of ``tp_answer_paths``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    out = {}
    for arch, before in zip(archs, befores):
        cfg = tp_answer_cfg(get_config, arch, model)
        params = tree_map(lambda t: t.float(), T.init_model(
            cfg, seed=0, device=dev, model=model, m=m))
        L.moe_fwd.dropped = []
        out[arch] = tp_answer_paths(torch, T, cfg, params,
                                    tp_answer_inputs(torch, cfg), tp, before)
        out[arch]["dropped"] = sum(L.moe_fwd.dropped)
        L.moe_fwd.dropped = None
        del params
        torch.cuda.empty_cache()
    return out


def tp_answer_ones(torch, T, get_config) -> tuple[dict, list]:
    """Phase 24d's one-rank runs in this process, before the spawn of
    ``pool4_rank``: the runs, and the ranks' jobs (``tp_answer_rank``)."""
    from repro_torch.tree import tree_map

    ones, jobs = {}, []
    for model, archs in TP_ANSWER.items():
        befores = []
        for arch in archs:
            cfg = tp_answer_cfg(get_config, arch, model)
            params = tree_map(lambda t: t.float(),
                              T.init_model(cfg, seed=0, device="cuda"))
            ones[model, arch] = tp_answer_paths(torch, T, cfg, params,
                                                tp_answer_inputs(torch, cfg))
            befores.append(ones[model, arch].pop("before"))
            del params
            torch.cuda.empty_cache()
        jobs.append((model, archs, befores))
    return ones, jobs


def tp_answer_phase(get_config, ones, every) -> None:
    """Phase 24d: the three configs of 24a-c at full width and their smoke
    depth in f32 on the card, each model group (``every``: each rank's
    ``tp_answer_rank`` result) against the one-rank model in this process
    on the same weights (``ones``, ``tp_answer_ones``): the paged and the
    dense prefill's logits within TP_F32_TOL; each paged and each dense
    decode step, from the one-rank run's pools or cache, within
    TP_STEP_TOL (the step rounds the k and v it writes to bf16, and an f32
    value a summation order apart may round to the neighbouring bf16
    number); no expert slot dropped."""
    for model, archs in TP_ANSWER.items():
        ranks = [r[model] for r in every[:model]]
        for arch in archs:
            one, got = ones[model, arch], ranks[0][arch]
            steps = lambda k: k.endswith("_steps")
            err = lambda k: float(max(abs(a - b).max() for a, b in zip(
                got[k] if steps(k) else [got[k]],
                one[k] if steps(k) else [one[k]])))
            rec = {"arch": arch, "model": model,
                   "layers": tp_answer_cfg(get_config, arch, model).n_layers,
                   "paged_prefill_max_abs_err": err("paged_prefill"),
                   "paged_steps_max_abs_err": err("paged_steps"),
                   "dense_prefill_max_abs_err": err("dense_prefill"),
                   "dense_steps_max_abs_err": err("dense_steps"),
                   "prefill_tol": TP_F32_TOL, "step_tol": TP_STEP_TOL,
                   "dropped": [r[arch]["dropped"] for r in ranks]}
            print(json.dumps({"tp_f32_vs_one_rank": rec}), flush=True)
            if not (rec["paged_prefill_max_abs_err"] <= TP_F32_TOL
                    and rec["dense_prefill_max_abs_err"] <= TP_F32_TOL
                    and rec["paged_steps_max_abs_err"] <= TP_STEP_TOL
                    and rec["dense_steps_max_abs_err"] <= TP_STEP_TOL) \
                    or any(rec["dropped"]):
                fail(f"{arch} on a model axis of {model} in f32: {rec}")


def tp_train_case(train, name, kw, cfg, refs) -> dict:
    """Phase 25a/25b: ``train`` of gpt-100m at full width and depth on
    ``kw``'s grid; ``refs`` the steady step ms of phases 7 and 11.
    Returns every rank's launches."""
    t0 = time.perf_counter()
    out = train("gpt-100m", device="cuda", log_every=1, **kw)
    wall = time.perf_counter() - t0
    steps, leaves = kw["steps"], 10
    compress = kw["comm"] == "multilevel_compress"
    want = {"wkv": 0, "flash_fwd": 2 * cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps,
            "flash_bwd_dkv": cfg.n_layers * steps, "quantize_int8": 0,
            "dequantize_int8": leaves * steps * compress,
            "quantize_ef_int8": leaves * steps * compress}
    steady = out["step_ms"][1:]
    print(json.dumps({f"tp_train_{name}": {
        **kw, "world": out["world"], "model": out["model"],
        "backend": out["backend"], "staging": out["staging"],
        "losses": out["losses"], "step_ms": out["step_ms"],
        "steady_step_ms_mean": sum(steady) / len(steady),
        "tokens_per_s": out["tokens_per_s"],
        "one_rank_steady_step_ms_phase_7": refs["7"],
        "grid_2x2x1_steady_step_ms_phase_11": refs["11"],
        "tp_calls_per_step": out["tp_calls"],
        "staged_bytes_per_step": out["staged_bytes"],
        "slow_wire_bytes_per_step": out["slow_wire_bytes"],
        "slow_f32_bytes_per_step": out["slow_f32_bytes"],
        "launches_per_rank": out["launches"],
        "wall_s_with_spawn": wall}}), flush=True)
    if len(out["losses"]) != steps \
            or not all(math.isfinite(x) for x in out["losses"]):
        fail(f"phase {name}: losses {out['losses']}")
    if any(c != out["tp_calls"][0] for c in out["tp_calls"]) \
            or min(out["tp_calls"][0].values()) < 1:
        fail(f"phase {name}: model-axis collectives a step "
             f"{out['tp_calls']}")
    if len(out["launches"]) != 4 or any(r != want for r in out["launches"]):
        fail(f"phase {name}: the ranks launched {out['launches']}, "
             f"expected {want} each")
    return out["launches"]


def tp_train_answer_losses(grid, cfg, full, device) -> list:
    """3 f32 steps of 25c on ``grid`` on ``device`` from the global
    stacked parameters ``full`` (CPU), this rank's model shard of them."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.step import make_train_step
    from repro_torch.models.convert import model_dims, shard_params
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    tp = grid.tp
    p = full if tp is None else shard_params(full, cfg, tp.size, tp.index)
    p = tree_map(lambda t: t.to(device), p)
    opt_cfg = adamw.OptConfig(comm_mode="multilevel", lr=1e-3,
                              warmup_steps=20, clip_norm=1e30,
                              total_steps=TP_TRAIN_ANSWER["steps"])
    opt = adamw.shard_opt_state(
        adamw.init_opt_state(p, opt_cfg, n_slow=grid.pods), p, opt_cfg,
        grid, None if tp is None else model_dims(cfg, tp.size))
    step = make_train_step(cfg, opt_cfg, grid, torch.device(device))
    pipe = DataPipeline(cfg, ShapeSpec("answer", "train",
                                       TP_TRAIN_ANSWER["seq"],
                                       TP_TRAIN_ANSWER["batch"]))
    losses = []
    for i in range(TP_TRAIN_ANSWER["steps"]):
        p, opt, loss = step(p, opt, pipe.host_batch(i))
        losses.append(loss.item())
    return losses


def tp_train_answer_rank(rank, world):
    """One rank of 25c: each grid of ``TP_TRAIN_GRIDS[world]`` on each of
    its devices, from the same f32 weights."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_grid
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import stack_runs
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    cfg = cut(get_config, "gpt-100m", 2)
    full = stack_runs(tree_map(lambda t: t.float(), T.init_model(
        cfg, seed=0, device="cpu")), cfg)
    out = {}
    for (pods, data, model), devices in TP_TRAIN_GRIDS[world]:
        grid = make_grid(pods, data, torch.device("cuda", 0), model=model)
        for dev in devices:
            out[f"{pods}x{data}x{model} {dev}"] = tp_train_answer_losses(
                grid, cfg, full, dev)
    return out


def tp_train_answer(torch, T, get_config, pooled) -> None:
    """Phase 25c: gpt-100m's 2 layers at full width in f32, unclipped, on
    1x1x2 and 2x1x2 on the card and on the CPU, against one rank and 2x1x1
    on the card, the same global batches: the losses within TP_TRAIN_TOL.
    ``pooled``: the first rank's ``tp_train_answer_rank`` result of each
    world of TP_TRAIN_GRIDS (the spawns of ``tp_rs_rank`` and
    ``pool4_rank``)."""
    from repro_torch.launch.mesh import Grid
    from repro_torch.models.convert import stack_runs
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg = cut(get_config, "gpt-100m", 2)
    full = stack_runs(tree_map(lambda t: t.float(), T.init_model(
        cfg, seed=0, device="cpu")), cfg)
    runs = {"1x1x1 cuda": tp_train_answer_losses(Grid.single(), cfg, full,
                                                 "cuda")}
    torch.cuda.empty_cache()
    for world in TP_TRAIN_GRIDS:
        runs.update(pooled[world])
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(
        runs[a], runs[b]))
    pairs = [("1x1x2 cuda", "1x1x1 cuda"), ("2x1x2 cuda", "1x1x1 cuda"),
             ("2x1x2 cuda", "2x1x1 cuda"), ("1x1x2 cuda", "1x1x2 cpu"),
             ("2x1x2 cuda", "2x1x2 cpu")]
    errs = {f"{a} vs {b}": rel(a, b) for a, b in pairs}
    print(json.dumps({"tp_train_25c_f32": {
        **TP_TRAIN_ANSWER, "layers": 2, "comm": "multilevel",
        "clip_norm": 1e30, "losses": runs, "max_rel_loss_diff": errs,
        "tolerance": TP_TRAIN_TOL,
        "wall_s_one_rank": time.perf_counter() - t0}}), flush=True)
    if any(len(v) != TP_TRAIN_ANSWER["steps"] for v in runs.values()) \
            or not all(math.isfinite(e) and e <= TP_TRAIN_TOL
                       for e in errs.values()):
        fail(f"phase 25c: f32 losses on a model axis {errs} (relative), "
             f"tolerance {TP_TRAIN_TOL}")


def tp_train_qwen(torch, train, get_config) -> list:
    """Phase 25d: qwen3-4b at full width cut to 4 layers on 1x1x2 in bf16
    against one rank in this process, the same weights and batches:
    finite losses, the first step's within TP_QWEN_TOL.  Returns the
    ranks' launches."""
    arch, n, mesh, kw = TP_QWEN
    cfg = cut(get_config, arch, n)
    t0 = time.perf_counter()
    two = train(arch, config=cfg, mesh_spec=mesh, device="cuda",
                dist_backend="gloo", log_every=1, **kw)
    t1 = time.perf_counter()
    one = train(arch, config=cfg, device="cuda", log_every=1, **kw)
    t2 = time.perf_counter()
    torch.cuda.empty_cache()
    rel = abs(two["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
    print(json.dumps({"tp_train_25d": {
        "arch": arch, "layers": n, "mesh": mesh, **kw, "dtype": "bfloat16",
        "losses": two["losses"], "losses_one_rank": one["losses"],
        "first_step_rel_diff": rel, "tolerance": TP_QWEN_TOL,
        "step_ms": two["step_ms"], "step_ms_one_rank": one["step_ms"],
        "tp_calls_per_step": two["tp_calls"],
        "staged_bytes_per_step": two["staged_bytes"],
        "launches_per_rank": two["launches"],
        "wall_s_with_spawn": t1 - t0, "wall_s_one_rank": t2 - t1}}),
        flush=True)
    steps = kw["steps"]
    want = {"wkv": 0, "flash_fwd": 2 * n * steps, "flash_bwd_dq": n * steps,
            "flash_bwd_dkv": n * steps, "quantize_int8": 0,
            "dequantize_int8": 0, "quantize_ef_int8": 0}
    if not all(math.isfinite(x) for x in two["losses"] + one["losses"]) \
            or not rel <= TP_QWEN_TOL:
        fail(f"phase 25d: losses {two['losses']} on {mesh}, "
             f"{one['losses']} on one rank")
    if len(two["launches"]) != 2 or any(r != want for r in two["launches"]):
        fail(f"phase 25d: the ranks launched {two['launches']}, expected "
             f"{want} each")
    return two["launches"]


def family_train_case(torch, train, fa, kw, L, get_config, name) -> tuple:
    """26a-26d: ``train`` of one family's config in bf16 on one rank, the
    counters and the MoE's host syncs set to 0 just before and read just
    after: finite losses, a flash launch per attention call (encoder and
    cross layers included) and step, twice for the forward (remat);
    printed with the parameter count, each step's wall ms and loss, peak
    memory and, for the MoE, the host syncs of the routing.  Returns the
    launches and the mean wall ms of a step after the first."""
    from repro_torch.launch.step import layer_grad_bytes

    arch, n, kw_ = FAMILY_TRAIN[name]
    cfg = cut(get_config, arch, n)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset(fa, kw)
    L.moe_fwd.host_syncs = 0
    t0 = time.perf_counter()
    out = train(arch, config=cfg, device="cuda", log_every=1, **kw_)
    wall = time.perf_counter() - t0
    got, syncs = counts(fa, kw), L.moe_fwd.host_syncs
    calls = flash_per_prefill(cfg) * kw_["steps"]
    want = {"flash_fwd": 2 * calls, "flash_bwd_dq": calls,
            "flash_bwd_dkv": calls, "wkv": 0}
    steady = out["step_ms"][1:]
    rec = {"arch": arch, "layers": cfg.n_layers,
           "layers_full": get_config(arch).n_layers,
           "enc_layers": cfg.enc_dec.n_enc_layers if cfg.enc_dec else 0,
           "params": int(sum(layer_grad_bytes(cfg)) // 4), **kw_,
           "dtype": "bfloat16", "losses": out["losses"],
           "step_ms": out["step_ms"],
           "steady_step_ms_mean": sum(steady) / len(steady),
           "tokens_per_s": out["tokens_per_s"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": got, "head_dim": cfg.head_dim, "wall_s": wall}
    PEAK_GB[name] = rec["peak_mem_gb"]
    if cfg.moe:
        rec["moe_host_syncs"] = syncs
        rec["moe_host_syncs_per_step"] = syncs / kw_["steps"]
    print(json.dumps({f"family_train_{name}": rec}), flush=True)
    if len(out["losses"]) != kw_["steps"] \
            or not all(math.isfinite(x) for x in out["losses"]):
        fail(f"phase {name} ({arch}): losses {out['losses']}")
    if got != want:
        fail(f"phase {name} ({arch}): launched {got}, expected {want}")
    # one routing a layer in the forward and one in the remat's re-run
    if cfg.moe and syncs != 2 * cfg.n_layers * kw_["steps"]:
        fail(f"phase {name} ({arch}): {syncs} host syncs of the routing")
    torch.cuda.empty_cache()
    return got, rec["steady_step_ms_mean"]


def answer_step(torch, T, fa, kw, cfg, arch, n, key, phase) -> dict:
    """The f32 loss and gradient of ``cfg`` (``arch`` cut to ``n`` layers,
    None for the smoke config) on the card and on the CPU from the same
    weights and batch (``step.loss_and_grads``, as ``make_train_step``
    calls it): the loss within FAMILY_LOSS_TOL relative, each gradient
    leaf of the stacked layout within FAMILY_G_TOL of its largest; printed
    under ``key``.  Returns the card's launches."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.step import device_batch, loss_and_grads
    from repro_torch.models.convert import stack_runs
    from repro_torch.tree import tree_map, tree_paths

    pipe = DataPipeline(cfg, ShapeSpec("answer", "train",
                                       FAMILY_ANSWER_INPUT["seq"],
                                       FAMILY_ANSWER_INPUT["batch"]))
    batch = pipe.host_batch(0)
    # drawn on the card (quicker than on the CPU), the same on both sides
    full = tree_map(lambda t: t.float().cpu(), T.init_model(
        cfg, seed=0, device="cuda"))
    runs = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda t: t.to(dev), full)
        reset(fa, kw)
        loss, grads = loss_and_grads(params, cfg, device_batch(batch, dev))
        runs[dev] = (loss.item(), [(k, g.cpu().numpy()) for k, g in
                                   tree_paths(stack_runs(grads, cfg))],
                     counts(fa, kw))
        del params, grads
        torch.cuda.empty_cache()
    (l_gpu, g_gpu, launches), (l_cpu, g_cpu, _) = runs["cuda"], runs["cpu"]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    g_rel, zero = m_errs(g_gpu, g_cpu, cfg)
    print(json.dumps({key: {
        "arch": arch, "layers": cfg.n_layers, "smoke": n is None,
        **FAMILY_ANSWER_INPUT, "loss_card": l_gpu, "loss_cpu": l_cpu,
        "rel_loss_diff": rel, "loss_tolerance": FAMILY_LOSS_TOL,
        "grad_leaves": len(g_cpu), "grad_max_rel_diff": g_rel,
        "grad_tolerance": FAMILY_G_TOL,
        "top1_router_grad_over_max_grad": zero,
        "launches_card": launches}}), flush=True)
    if not math.isfinite(rel) or rel > FAMILY_LOSS_TOL:
        fail(f"phase {phase} {arch}: f32 losses differ by {rel} (relative) "
             f"between card and CPU")
    if not math.isfinite(g_rel) or g_rel > FAMILY_G_TOL:
        fail(f"phase {phase} {arch}: the gradient differs by {g_rel} of its "
             f"largest between card and CPU")
    if not zero <= FAMILY_ZERO_TOL:
        fail(f"phase {phase} {arch}: the top-1 router's gradient is {zero} "
             f"of the largest, not a rounding residue")
    return launches


def m_errs(got, want, cfg) -> tuple[float, float]:
    """The largest difference of two first moments or gradients (lists of
    (path, numpy leaf)), each leaf's over its largest |m| in ``want``; and
    for a top-1 router, whose gradient is zero but for rounding (its
    renormalised gate is 1), the larger of its two |m| over the largest
    |m| of all leaves, held under FAMILY_ZERO_TOL."""
    import numpy as np

    top = max(np.abs(c).max() for _, c in want)
    m_rel, zero = 0.0, 0.0
    for (name, g), (_, c) in zip(got, want):
        if cfg.moe is not None and cfg.moe.top_k == 1 \
                and name.endswith("router"):
            zero = max(zero, float(max(np.abs(g).max(), np.abs(c).max())
                                   / top))
        else:
            m_rel = max(m_rel, float(np.abs(g - c).max()
                                     / max(np.abs(c).max(), 1e-30)))
    return m_rel, zero


def family_answer(torch, T, fa, kw, get_config) -> None:
    """26e: each family's config at full width (one pattern period, one
    layer, 1 + 1 for enc-dec, llama4-scout at its smoke size) in f32, the
    training step's loss and gradient on the card and on the CPU from the
    same weights and batch (``answer_step``)."""
    for arch, n in FAMILY_ANSWER:
        cfg = get_config(arch, smoke=True) if n is None \
            else cut(get_config, arch, n)
        answer_step(torch, T, fa, kw, cfg, arch, n,
                    "family_train_f32_card_vs_cpu", "26e")


def family_grid_losses(grid, dev):
    """26f's steps on ``grid`` (one rank: ``Grid.single()``) on ``dev``
    from the f32 weights of seed 0; returns the losses."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.step import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import stack_runs
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    arch, n, kw_ = FAMILY_GRID
    cfg = cut(get_config, arch, n)
    opt_cfg = adamw.OptConfig(comm_mode="multilevel_compress", lr=1e-3,
                              warmup_steps=20, total_steps=kw_["steps"])
    params = stack_runs(tree_map(lambda t: t.float().to(dev), T.init_model(
        cfg, seed=0, device="cpu")), cfg)
    opt = adamw.shard_opt_state(adamw.init_opt_state(
        params, opt_cfg, n_slow=grid.pods), params, opt_cfg, grid)
    step = make_train_step(cfg, opt_cfg, grid, dev)
    pipe = DataPipeline(cfg, ShapeSpec("grid", "train", kw_["seq"],
                                       kw_["batch"]))
    losses = []
    for i in range(kw_["steps"]):
        params, opt, loss = step(params, opt, pipe.host_batch(i))
        losses.append(loss.item())
    return losses


def family_grid_rank(rank):
    """One rank of 26f on the card, its counters from 0."""
    import torch
    from repro_torch.launch.mesh import make_grid
    from repro_torch.launch.train import launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    before = launch_counts()
    losses = family_grid_losses(make_grid(2, 2, dev), dev)
    return {"losses": losses, "launches": {
        k: v - before[k] for k, v in launch_counts().items()}}


def family_grid(torch, get_config, res) -> list:
    """26f: olmoe-1b-7b at full width cut to 1 layer, f32, 2x2x1
    ``multilevel_compress`` with ZeRO-1 on ranks sharing the card over
    gloo (``res``: each rank's ``family_grid_rank`` result, from the
    spawn of ``pool4_rank``), against one rank on the card: every rank's
    losses within FAMILY_GRID_TOL, #5 and #6 once a stacked leaf (expert
    leaves included) a step on each rank.  Returns the ranks' launches."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import Grid
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import stack_runs
    from repro_torch.tree import tree_leaves

    arch, n, kw_ = FAMILY_GRID
    cfg = cut(get_config, arch, n)
    one = family_grid_losses(Grid.single(), torch.device("cuda"))
    torch.cuda.empty_cache()
    with FakeTensorMode():        # the shapes only; nothing allocated
        leaves = len(tree_leaves(stack_runs(T.init_model(
            cfg, seed=0, device="cpu"), cfg)))
    rel = max(abs(g - o) / abs(o) for r in res
              for g, o in zip(r["losses"], one))
    steps = kw_["steps"]
    want = {"wkv": 0, "flash_fwd": 2 * n * steps, "flash_bwd_dq": n * steps,
            "flash_bwd_dkv": n * steps, "quantize_int8": 0,
            "dequantize_int8": leaves * steps,
            "quantize_ef_int8": leaves * steps}
    print(json.dumps({"family_train_26f": {
        "arch": arch, "layers": n, **kw_, "grid": "2x2x1",
        "comm": "multilevel_compress", "dtype": "float32",
        "losses": [r["losses"] for r in res], "losses_one_rank": one,
        "max_rel_loss_diff": rel, "tolerance": FAMILY_GRID_TOL,
        "launches_per_rank": [r["launches"] for r in res]}}), flush=True)
    if not math.isfinite(rel) or rel > FAMILY_GRID_TOL:
        fail(f"phase 26f: the grid's f32 losses differ by {rel} (relative) "
             f"from one rank's")
    if any(r["launches"] != want for r in res):
        fail(f"phase 26f: the ranks launched "
             f"{[r['launches'] for r in res]}, expected {want} each")
    return [r["launches"] for r in res]


def rwkv_train_case(torch, train, fa, kw, get_config) -> dict:
    """27a: ``train`` of rwkv6-1.6b at full width and depth in bf16 on one
    rank, the counters set to 0 just before and read just after: finite
    losses and two WKV launches a layer and step (the forward's and the
    remat's re-run inside the backward); printed with the parameter
    count, each step's wall ms and loss, tok/s and peak memory.  Returns
    the launches and the mean wall ms of a step after the first."""
    from repro_torch.launch.step import layer_grad_bytes

    cfg = get_config("rwkv6-1.6b")
    steps = RWKV_TRAIN["steps"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset(fa, kw)
    t0 = time.perf_counter()
    out = train(cfg.name, config=cfg, device="cuda", log_every=1,
                **RWKV_TRAIN)
    wall = time.perf_counter() - t0
    got = counts(fa, kw)
    want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "wkv": 2 * cfg.n_layers * steps}
    steady = out["step_ms"][1:]
    PEAK_GB["27a"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"rwkv_train_27a": {
        "arch": cfg.name, "layers": cfg.n_layers,
        "params": int(sum(layer_grad_bytes(cfg)) // 4), **RWKV_TRAIN,
        "dtype": "bfloat16", "losses": out["losses"],
        "step_ms": out["step_ms"],
        "steady_step_ms_mean": sum(steady) / len(steady),
        "tokens_per_s": out["tokens_per_s"],
        "peak_mem_gb": PEAK_GB["27a"],
        "launches": got,
        "wkv_per_layer_and_step": got["wkv"] / (cfg.n_layers * steps),
        "wall_s": wall}}), flush=True)
    if len(out["losses"]) != steps \
            or not all(math.isfinite(x) for x in out["losses"]):
        fail(f"phase 27a: losses {out['losses']}")
    if got != want:
        fail(f"phase 27a: launched {got}, expected {want}")
    torch.cuda.empty_cache()
    return got, sum(steady) / len(steady)


def tp_moe_train(torch, train, get_config, one_rank_ms) -> list:
    """27c: ``train`` of olmoe-1b-7b at full width cut to 4 layers on
    1x1x2 ranks sharing the card over gloo, bf16, each rank's counters from
    0 in its fresh process: finite losses, each rank's flash launches (2,
    1, 1 a layer and step), its two host reads of the routing a layer and
    step, the same model-axis collectives each step; printed with the
    slots each layer dropped on each rank, the collectives a step, the
    bytes staged, step ms beside 26c's one rank (``one_rank_ms``) and
    each rank's peak memory.  Returns the ranks' launches."""
    arch, n, kw_ = TP_MOE_TRAIN
    cfg = cut(get_config, arch, n)
    steps = kw_["steps"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = train(arch, config=cfg, device="cuda", dist_backend="gloo",
                log_every=1, **kw_)
    wall = time.perf_counter() - t0
    steady = out["step_ms"][1:]
    want = {"wkv": 0, "flash_fwd": 2 * n * steps, "flash_bwd_dq": n * steps,
            "flash_bwd_dkv": n * steps, "quantize_int8": 0,
            "dequantize_int8": 0, "quantize_ef_int8": 0}
    print(json.dumps({"tp_moe_train_27c": {
        "arch": arch, "layers": n, **kw_, "dtype": "bfloat16",
        "experts_per_rank": cfg.moe.n_experts // out["model"],
        "capacity_factor": cfg.moe.capacity_factor,
        "losses": out["losses"], "step_ms": out["step_ms"],
        "steady_step_ms_mean": sum(steady) / len(steady),
        "one_rank_steady_step_ms_26c": one_rank_ms,
        "tokens_per_s": out["tokens_per_s"],
        "tp_calls_per_step": out["tp_calls"],
        "staged_bytes_per_step": out["staged_bytes"],
        "moe_per_rank": out["moe"],
        "peak_mem_gb_per_rank": [b / 1e9 for b in out["peak_mem_bytes"]],
        "launches_per_rank": out["launches"],
        "wall_s_with_spawn": wall}}), flush=True)
    if len(out["losses"]) != steps \
            or not all(math.isfinite(x) for x in out["losses"]):
        fail(f"phase 27c: losses {out['losses']}")
    if any(c != out["tp_calls"][0] for c in out["tp_calls"]) \
            or min(out["tp_calls"][0].values()) < 1:
        fail(f"phase 27c: model-axis collectives a step {out['tp_calls']}")
    if len(out["launches"]) != 2 or any(r != want for r in out["launches"]):
        fail(f"phase 27c: the ranks launched {out['launches']}, expected "
             f"{want} each")
    if any(r["syncs"] != [2 * n] * steps or len(r["dropped"]) != steps
           or any(len(d) != n for d in r["dropped"]) for r in out["moe"]):
        fail(f"phase 27c: the routing's host reads and drops {out['moe']}")
    return out["launches"]


def tp_family_cfg(get_config, arch, n):
    """27d's config: ``arch`` at full width cut to ``n`` layers, a MoE's
    capacity factor at the axis size (every slot may land on one rank)."""
    cfg = cut(get_config, arch, n)
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(TP_FAMILY_ANSWER_INPUT["model"])))


def tp_family_step(grid, cfg, dev):
    """One f32 unclipped step of 27d on ``grid`` (one rank:
    ``Grid.single()``) on ``dev``, from the seed-0 weights drawn on the
    card (this rank's model shard of them): the loss, Adam's first
    moment (the stacked layout, on the card), the slots dropped, the
    flash kernels' launches."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.step import make_train_step
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import (model_dims, shard_params,
                                            stack_runs)
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    tp = grid.tp
    p = stack_runs(tree_map(lambda t: t.float(), T.init_model(
        cfg, seed=0, device=dev)), cfg)
    if tp is not None:
        p = shard_params(p, cfg, tp.size, tp.index)
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=20, total_steps=1,
                              clip_norm=1e30)
    opt = adamw.shard_opt_state(
        adamw.init_opt_state(p, opt_cfg), p, opt_cfg, grid,
        None if tp is None else model_dims(cfg, tp.size))
    step = make_train_step(cfg, opt_cfg, grid, dev)
    pipe = DataPipeline(cfg, ShapeSpec("answer", "train",
                                       TP_FAMILY_ANSWER_INPUT["seq"],
                                       TP_FAMILY_ANSWER_INPUT["batch"]))
    kernels = {"flash_fwd": fa.flash_attention_fwd,
               "flash_bwd_dq": fa.flash_bwd_dq,
               "flash_bwd_dkv": fa.flash_bwd_dkv}
    f0 = {k: f.launches for k, f in kernels.items()}
    L.moe_fwd.dropped = dropped = []
    try:
        p, opt, loss = step(p, opt, pipe.host_batch(0))
    finally:
        L.moe_fwd.dropped = None
    return {"loss": loss.item(), "m": opt["m"], "dropped": dropped,
            "flash": {k: f.launches - f0[k] for k, f in kernels.items()}}


def tp_family_rank(rank):
    """One rank of 27d on the card: for each config, the step on one rank
    (``Grid.single()``, in this process) and on 1x1x2, and this rank's
    moment against the one-rank moment's shard (``m_errs``); returns the
    losses, the errors, the drops and the model-axis step's flash
    launches, not the moments."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Grid, make_grid
    from repro_torch.models.convert import shard_params
    from repro_torch.tree import tree_map, tree_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    M = TP_FAMILY_ANSWER_INPUT["model"]
    grid = make_grid(1, 1, dev, model=M)
    out = {}
    for arch, n in TP_FAMILY_ANSWER:
        cfg = tp_family_cfg(get_config, arch, n)
        one = tp_family_step(Grid.single(), cfg, dev)
        want = shard_params(one.pop("m"), cfg, M, grid.tp.index)
        torch.cuda.empty_cache()
        got = tp_family_step(grid, cfg, dev)
        host = lambda tree: [(k, t.cpu().numpy())
                             for k, t in tree_paths(tree)]
        m_rel, zero = m_errs(host(got.pop("m")), host(want), cfg)
        out[arch] = {**got, "loss_one_rank": one["loss"], "m_rel": m_rel,
                     "zero": zero, "m_leaves": len(tree_paths(want))}
        del want
        torch.cuda.empty_cache()
    return out


def tp_family_answer(get_config, ranks) -> dict:
    """27d: olmoe-1b-7b and pixtral-12b at full width cut to 1 layer in
    f32 on 1x1x2 ranks sharing the card over gloo, against one rank on the
    card, one unclipped step: the loss within TP_FAMILY_TOL relative, each
    rank's Adam first moment within TP_FAMILY_TOL of the one-rank
    moment's shard, each leaf of its largest; no slot dropped.  Each rank
    runs the one-rank step too and compares on the card, so no moment
    crosses between processes.  ``ranks``: each rank's
    ``tp_family_rank`` result (from phase 28's spawn, ``tp_rs_rank``).
    Returns the ranks' flash launches on the axis, summed."""
    M = TP_FAMILY_ANSWER_INPUT["model"]
    flash = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for arch, n in TP_FAMILY_ANSWER:
        res = [r[arch] for r in ranks]
        rel = max(abs(r["loss"] - r["loss_one_rank"]) / abs(r["loss_one_rank"])
                  for r in res)
        m_rel = max(r["m_rel"] for r in res)
        zero = max(r["zero"] for r in res)
        for r in res:
            for k, v in r["flash"].items():
                flash[k] += v
        cfg = tp_family_cfg(get_config, arch, n)
        rec = {"arch": arch, "layers": n, **TP_FAMILY_ANSWER_INPUT,
               "capacity_factor": cfg.moe and cfg.moe.capacity_factor,
               "losses_ranks": [r["loss"] for r in res],
               "loss_one_rank": res[0]["loss_one_rank"],
               "rel_loss_diff": rel, "m_leaves": res[0]["m_leaves"],
               "m_max_rel_diff": m_rel, "top1_router_m_over_max_m": zero,
               "tolerance": TP_FAMILY_TOL,
               "dropped": [r["dropped"] for r in res],
               "flash_per_rank": [r["flash"] for r in res]}
        print(json.dumps({"tp_family_f32_vs_one_rank_27d": rec}),
              flush=True)
        want = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
        if not (math.isfinite(rel) and rel <= TP_FAMILY_TOL
                and math.isfinite(m_rel) and m_rel <= TP_FAMILY_TOL
                and zero <= FAMILY_ZERO_TOL) \
                or any(any(d) for d in rec["dropped"]) \
                or any(f != want for f in rec["flash_per_rank"]):
            fail(f"phase 27d: {arch} on a model axis of {M} in f32: {rec}")
    return flash


def tp_rs_rank(rank):
    """One of the two ranks that 24c, 25c (its 1x1x2 and 2x1x1 grids),
    27d and phases 28-29 share, one spawn: 24c's dense path
    (``tp_dense_rank``), 25c's grids (``tp_train_answer_rank``), 27d's
    answer (``tp_family_rank``), the dense path of each of TP_RS_SERVE
    (``tp_dense_rank``), the training of each of TP_RS_TRAIN (28c, 29b:
    ``tp_rs_train_rank``), then the answers of TP_RS_ANSWER (28d, 29c:
    ``tp_rs_answer_rank``); each body sets its counters to 0."""
    import torch
    from repro_torch.launch.mesh import make_grid

    arch, n, mesh, prefills = TP_DENSE
    out = {"24c": tp_dense_rank(rank, mesh, arch, n, prefills)}
    torch.cuda.empty_cache()
    out["25c"] = tp_train_answer_rank(rank, 2)
    torch.cuda.empty_cache()
    out["27d"] = tp_family_rank(rank)
    out.update({name: tp_dense_rank(rank, TP_RS_MESH, arch, None,
                                    ((B, L_),), P, TP_RS_GEN)
                for name, (arch, B, L_, P) in TP_RS_SERVE.items()})
    dev = torch.device("cuda", 0)
    grid = make_grid(1, 1, dev, model=2)
    out["train"] = {arch: tp_rs_train_rank(grid, arch, n, dev)
                    for arch, (n, _) in TP_RS_TRAIN.items()}
    out["answer"] = tp_rs_answer_rank(rank)
    return out


def tp_rs_serve(torch, T, kw, get_config, name, ranks, spec=None,
                mesh=TP_RS_MESH, one=None, quantum=False,
                n_gen=TP_RS_GEN, layers=None) -> tuple[list, dict]:
    """28a/28b/29a/31a: the dense path of ``spec`` (arch, batch, prompt,
    encoder frames; ``TP_RS_SERVE[name]`` by default) at full width and
    depth on ``mesh`` (``ranks``, each rank's ``tp_dense_rank`` result
    from a fresh process holding its shard, counters from 0), against the
    one-rank run on the same weights (in this process, or ``one``, what
    an earlier call on the same spec returned: the model is not run
    whole a second time; ``n_gen`` tokens, at most its TP_RS_GEN): the
    ranks' tokens equal (and equal to the one-rank run's, for the phases
    of TP_RS_SAME_TOKENS); the first prefill's bf16 logits no farther
    from the one-rank f32 model's (the same weights in f32) than the
    one-rank bf16 run's are, plus LOGIT_TOL (at full depth the bf16
    model's own rounding moves its logits by more than
    LOGIT_TOL: the model axis may add LOGIT_TOL to that, no more); each
    rank's WKV launches (one a layer and prefill, on its H/M heads) or
    flash launches (the encoder's, the decoder's and the cross
    attention's, on its heads).  Printed: the tokens beside the one-rank
    run's, the logits' distances, the WKV launch plan at H/M heads,
    prefill and decode ms beside one rank's, the collectives a prefill and
    a step, the bytes each rank staged.  ``quantum`` (31a, the logits far
    from 1): the bound on the bf16 logits takes one bf16 step of the
    largest f32 logit where that is above LOGIT_TOL (the logits leave the
    model as bf16 products, so two bf16 runs whose hidden states differ
    at all may land a step apart), and the ranks' f32 prefill of the same
    weights (``f32_first_logits``) is held to the one-rank f32 model's
    within TP_F32_TOL.  ``layers``: the layers kept (all where None).  No
    rank's expert-parallel block may drop a slot.  Returns the ranks'
    launches and the one-rank run (its tokens, first logits and times,
    and the f32 model's first logits)."""
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models.sharding import rwkv_heads
    from repro_torch.tree import tree_map

    arch, B, L_, P = spec or TP_RS_SERVE[name]
    model = parse_mesh(mesh)[2]
    cfg = cut(get_config, arch, layers)
    if one is None:
        params = T.init_model(cfg, seed=0, device="cuda")
        run = dense_serve(torch, cfg, params, B, L_, P, align=8,
                          gen=TP_RS_GEN)
        params = tree_map(lambda t: t.float(), params)
        ins = {k: v.cuda() for k, v in prompt_inputs(torch, cfg, B, L_, P,
                                                       L_).items()}
        f32, _, _ = T.prefill(params, cfg, ins, L_ + TP_RS_GEN)
        one = {"tokens": run["tokens"].cpu().numpy(),
               "logits": run["logits"][0].float().cpu().numpy(),
               "f32": f32.cpu().numpy(), "prefill_ms": run["prefill_ms"],
               "decode_ms_per_step": run["decode_ms_per_step"]}
        del params, ins, run, f32
        torch.cuda.empty_cache()
    f32, one_lg = one["f32"], one["logits"]
    r = ranks[0]["runs"][0]
    gen = r["tokens"]
    err = float(abs(r["first_logits"] - one_lg).max())
    err_f32 = float(abs(r["first_logits"] - f32).max())
    one_f32 = float(abs(one_lg - f32).max())
    top = float(abs(f32).max())
    tol = max(LOGIT_TOL, 2.0 ** (math.floor(math.log2(top)) - 7)) \
        if quantum else LOGIT_TOL
    rec = {"arch": arch, "layers": cfg.n_layers, "mesh": mesh,
           "batch": B, "prompt": L_, "encoder_frames": P,
           "generated": n_gen, "prefill_wall_ms": r["prefill_ms"],
           "decode_wall_ms_per_step": r["decode_ms_per_step"],
           "one_rank_prefill_wall_ms": one["prefill_ms"],
           "one_rank_decode_wall_ms_per_step": one["decode_ms_per_step"],
           "collectives_prefill": r["collectives_prefill"],
           "collectives_per_decode_step": r["collectives_per_decode_step"],
           "staged_bytes": [x["runs"][0]["staged_bytes"] for x in ranks],
           "first_prefill_max_abs_logit_err_bf16": err,
           "first_prefill_max_abs_logit_err_vs_f32": err_f32,
           "one_rank_max_abs_logit_err_vs_f32": one_f32,
           "max_abs_logit_f32": top, "logit_tol": tol,
           "tokens": gen.tolist(),
           "tokens_one_rank": one["tokens"][:, :n_gen].tolist(),
           "wkv_launches": [x["wkv"] for x in ranks],
           "flash_fwd_launches": [x["flash_fwd"] for x in ranks],
           "peak_mem_gb_per_rank": [x["peak_mem_gb"] for x in ranks],
           "dropped_per_rank": [sum(x["dropped"]) for x in ranks]}
    if "rwkv6" in cfg.pattern:
        hd = cfg.rwkv_head_dim
        rec["wkv_plan_heads_per_rank"] = rwkv_heads(cfg, model, 0).nh
        rec["wkv_launch_plan"] = kw.launch_plan(
            B, rec["wkv_plan_heads_per_rank"], hd)
        rec["wkv_launch_plan_batch_1"] = kw.launch_plan(
            1, rec["wkv_plan_heads_per_rank"], hd)
    if quantum:
        rec["f32_first_prefill_max_abs_err"] = max(
            float(abs(x["f32_first_logits"] - f32).max()) for x in ranks)
    print(json.dumps({f"tp_rs_serve_{name}": rec}), flush=True)
    want = {"flash_fwd": flash_per_prefill(cfg),
            "wkv": sum(k == "rwkv6" for k in cfg.pattern)}
    if not r["finite"] or gen.shape != (B, n_gen) or gen.min() < 0 \
            or gen.max() >= cfg.vocab:
        fail(f"phase {name}: tokens of shape {gen.shape} or non-finite "
             f"logits")
    if any(not (x["runs"][0]["tokens"] == gen).all() for x in ranks):
        fail(f"phase {name}: the ranks took other tokens")
    if any(rec["dropped_per_rank"]):
        fail(f"phase {name}: slots dropped {rec['dropped_per_rank']}")
    if name in TP_RS_SAME_TOKENS \
            and not (gen == one["tokens"][:, :n_gen]).all():
        fail(f"phase {name}: tokens {gen.tolist()}, one rank's "
             f"{one['tokens'][:, :n_gen].tolist()}")
    if not err_f32 <= one_f32 + tol:
        fail(f"phase {name}: first prefill's logits {err_f32} from the f32 "
             f"model's, the one-rank run's {one_f32}")
    if quantum and not rec["f32_first_prefill_max_abs_err"] <= TP_F32_TOL:
        fail(f"phase {name}: the f32 prefill on {mesh} is "
             f"{rec['f32_first_prefill_max_abs_err']} from one rank's")
    if any({k: x[k] for k in want} != want for x in ranks):
        fail(f"phase {name}: the ranks launched "
             f"{[{k: x[k] for k in want} for x in ranks]}, expected {want} "
             f"each")
    return [{k: x[k] for k in want} for x in ranks], one


def axis_counts(grid) -> dict:
    """Each axis's calls, backward calls and wire bytes so far, as
    ``launch.dryrun.run_rank`` gives them."""
    return {a.name: {"calls": a.calls, "bwd_calls": a.bwd_calls,
                     "wire_bytes": a.wire_bytes} for a in grid.axes()}


def tp_rs_train_rank(grid, arch, n, dev, train_kw=TP_RS_TRAIN_KW) -> dict:
    """28c/29b/31b on this rank of ``grid``: ``arch`` at full width cut to
    ``n`` layers, this rank's shard of the seed-0 weights in bf16, the
    steps of ``train_kw`` through ``make_train_step`` with ``train``'s
    optimiser settings, the counters set to 0 just before and read just
    after: the losses, each step's wall ms (until its loss reaches the
    host), the model axis's collectives and the bytes staged a step, the
    peak memory over the steps and the launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv as kw
    from repro_torch.launch.step import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import model_dims, stack_runs
    from repro_torch.optim import adamw

    tp, steps = grid.tp, train_kw["steps"]
    cfg = cut(get_config, arch, n)
    params = stack_runs(T.init_model(cfg, seed=0, device=dev, model=tp.size,
                                     m=tp.index), cfg, tp.size, tp.index)
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    opt = adamw.shard_opt_state(adamw.init_opt_state(params, opt_cfg),
                                params, opt_cfg, grid,
                                model_dims(cfg, tp.size))
    step = make_train_step(cfg, opt_cfg, grid, dev)
    pipe = DataPipeline(cfg, ShapeSpec("custom", "train",
                                       train_kw["seq"], train_kw["batch"]))
    torch.cuda.reset_peak_memory_stats(dev)
    reset(fa, kw)
    out = {"losses": [], "step_ms": [], "tp_calls": [], "staged_bytes": [],
           "axes": []}
    for i in range(steps):
        s0, t0 = grid.staged_bytes, time.perf_counter()
        a0 = axis_counts(grid)
        params, opt, loss = step(params, opt, pipe.host_batch(i))
        out["losses"].append(loss.item())
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["tp_calls"].append(dict(step.tp_calls))
        out["staged_bytes"].append(grid.staged_bytes - s0)
        out["axes"].append({n: {k: v - a0[n][k] for k, v in c.items()}
                            for n, c in axis_counts(grid).items()})
    out["launches"] = counts(fa, kw)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, opt
    torch.cuda.empty_cache()
    return out


def tp_rs_train(get_config, refs, ranks, phase, table=TP_RS_TRAIN,
                mesh=TP_RS_MESH, train_kw=TP_RS_TRAIN_KW) -> list:
    """28c/29b/31b: each entry of ``table`` (arch -> layers kept, phase)
    of ``phase`` at full width (rwkv6-1.6b cut to 4 of 24 layers, seamless
    whole; recurrentgemma-2b cut to 3 of 26) trained on ``mesh`` in bf16
    (``ranks``: each rank's
    ``tp_rs_train_rank`` results), the ranks sharing the card over gloo:
    finite losses, equal on the ranks, the same model-axis collectives
    each step, each rank's launches (RWKV-6: 2 WKV a layer and step;
    seamless and recurrentgemma: 2 flash forwards, one dq and one dk/dv
    an attention call and step).  Printed with the step ms after the
    first beside the one-rank step of ``refs`` (27a's rwkv6 at 24 layers
    and 8 x 512, 26b's seamless whole at 4 x 1024, 26a's recurrentgemma
    whole at 1 x 4096, each also scaled to the layers kept), tok/s, each
    rank's peak memory, the collectives a step and the bytes staged.
    Returns the ranks' launches."""
    out_launches = []
    steps = train_kw["steps"]
    for arch, (n, ph) in table.items():
        if ph != phase:
            continue
        cfg = cut(get_config, arch, n)
        res = [r[arch] for r in ranks]
        out = res[0]
        steady = out["step_ms"][1:]
        calls = flash_per_prefill(cfg) * steps
        wkv = 2 * sum(k == "rwkv6" for k in cfg.pattern) * steps
        want = {"flash_fwd": 2 * calls, "flash_bwd_dq": calls,
                "flash_bwd_dkv": calls, "wkv": wkv}
        tokens = train_kw["seq"] * train_kw["batch"]
        print(json.dumps({f"tp_rs_train_{phase}": {
            "arch": arch, "layers": cfg.n_layers, "mesh": mesh,
            **train_kw, "dtype": "bfloat16", "losses": out["losses"],
            "step_ms": out["step_ms"],
            "steady_step_ms_mean": sum(steady) / len(steady),
            "one_rank_steady_step_ms": refs[arch],
            "tokens_per_s": tokens * len(steady) / sum(steady) * 1e3,
            "tp_calls_per_step": out["tp_calls"],
            "staged_bytes_per_step": out["staged_bytes"],
            "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in res],
            "launches_per_rank": [r["launches"] for r in res]}}),
            flush=True)
        if len(out["losses"]) != steps \
                or not all(math.isfinite(x) for x in out["losses"]) \
                or any(r["losses"] != out["losses"] for r in res):
            fail(f"phase {phase}: {arch} losses "
                 f"{[r['losses'] for r in res]}")
        if any(c != out["tp_calls"][0] for r in res for c in r["tp_calls"]) \
                or min(out["tp_calls"][0].values()) < 1:
            fail(f"phase {phase}: {arch} model-axis collectives a step "
                 f"{[r['tp_calls'] for r in res]}")
        if any(r["launches"] != want for r in res):
            fail(f"phase {phase}: {arch} ranks launched "
                 f"{[r['launches'] for r in res]}, expected {want} each")
        out_launches += [r["launches"] for r in res]
    return out_launches


def tp_rs_answer_rank(rank, table=TP_RS_ANSWER, mesh=TP_RS_MESH,
                      turns=False, members=None):
    """One rank of 28d/29c/31c-d on the card: for each entry of ``table``,
    f32 seed-0 weights, the dense path and one unclipped train step on
    one rank (``Grid.single()``, in this process) and on this rank's shard
    of ``mesh``, compared here; returns the errors, the losses and the
    shard runs' WKV and flash launches.  With ``turns`` the ranks take
    the one-rank step one at a time (four one-rank f32 optimiser states
    of recurrentgemma-2b at 3 layers do not fit the card at once).
    ``members``: the ranks of the grid, where they are not all."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv as kw
    from repro_torch.launch.mesh import Grid, make_grid, parse_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import shard_params
    from repro_torch.tree import tree_map, tree_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    M = parse_mesh(mesh)[2]
    grid = make_grid(1, 1, dev, model=M, members=members)
    rank = grid.tp.index
    B, L_, P = TP_RS_ANSWER_INPUT
    out = {}
    for arch, n, _, _ in table:
        cfg = cut(get_config, arch, n)
        full = tree_map(lambda t: t.float(), T.init_model(cfg, seed=0,
                                                          device=dev))
        gen = torch.Generator().manual_seed(28)
        ins = {"tokens": torch.randint(0, cfg.vocab, (B, L_), generator=gen)}
        steps = torch.randint(0, cfg.vocab, (4, B, 1), generator=gen).to(dev)
        if cfg.enc_dec:
            ins["src_embeds"] = torch.randn((B, P, cfg.d_model),
                                            generator=gen)
        ins = {k: v.to(dev) for k, v in ins.items()}
        s_max = L_ + 8
        one = dense_answer_paths(torch, T, cfg, full, ins, steps, s_max)
        shard = shard_params(full, cfg, M, rank)
        del full
        reset(fa, kw)
        got = dense_answer_paths(torch, T, cfg, shard, ins, steps, s_max,
                                 grid.tp, one["before"])
        launches = counts(fa, kw)
        del shard, one["before"]
        err = lambda a, b: float((a - b).abs().max())
        rec = {"prefill_err": err(got["prefill"], one["prefill"]),
               "steps_err": max(err(a, b) for a, b in zip(got["steps"],
                                                          one["steps"]))}
        torch.cuda.empty_cache()
        for turn in range(M if turns else 1):
            if not turns or turn == rank:
                step_one = tp_family_step(Grid.single(), cfg, dev)
                want = shard_params(step_one.pop("m"), cfg, M, rank)
                torch.cuda.empty_cache()
            if turns:
                grid.barrier()
        f0 = counts(fa, kw)
        step = tp_family_step(grid, cfg, dev)
        f1 = counts(fa, kw)
        host = lambda tree: [(k, t.cpu().numpy())
                             for k, t in tree_paths(tree)]
        m_rel, _ = m_errs(host(step.pop("m")), host(want), cfg)
        out[arch] = {**rec, "loss": step["loss"],
                     "loss_one_rank": step_one["loss"], "m_rel": m_rel,
                     "m_leaves": len(tree_paths(want)),
                     "launches": {k: launches[k] + f1[k] - f0[k]
                                  for k in launches}}
        del want
        torch.cuda.empty_cache()
    return out


def tp_rs_answer(ranks, phase, table=TP_RS_ANSWER, mesh=TP_RS_MESH,
                 want=None) -> dict:
    """28d/29c/31c-d: the entries of ``table`` of ``phase`` (rwkv6-1.6b at 2
    layers and seamless-m4t-medium at 1 + 1; recurrentgemma-2b at 3) at
    full width in f32 on ``mesh``'s ranks sharing the card over gloo,
    against one rank on the card in each rank's process (nothing crosses
    between processes): the dense prefill's logits within TP_F32_TOL, 4
    decode steps from the one-rank cache within the entry's tolerance,
    one unclipped step's loss within TP_FAMILY_TOL relative and Adam's
    first moment (0.1 x the gradient) within TP_FAMILY_TOL of each leaf's
    largest.  ``ranks``: each rank's ``tp_rs_answer_rank`` result.
    ``want`` (arch -> launches), where given, is each rank's count of the
    shard runs' launches.  Returns those launches, summed over the
    ranks."""
    total = {}
    for arch, n, ph, step_tol in table:
        if ph != phase:
            continue
        res = [r[arch] for r in ranks]
        rel = max(abs(r["loss"] - r["loss_one_rank"]) / abs(r["loss_one_rank"])
                  for r in res)
        rec = {"arch": arch, "layers": n, "mesh": mesh,
               "input": TP_RS_ANSWER_INPUT,
               "prefill_max_abs_err": max(r["prefill_err"] for r in res),
               "steps_max_abs_err": max(r["steps_err"] for r in res),
               "prefill_tol": TP_F32_TOL, "step_tol": step_tol,
               **TP_FAMILY_ANSWER_INPUT,
               "losses_ranks": [r["loss"] for r in res],
               "loss_one_rank": res[0]["loss_one_rank"],
               "rel_loss_diff": rel, "m_leaves": res[0]["m_leaves"],
               "m_max_rel_diff": max(r["m_rel"] for r in res),
               "train_tol": TP_FAMILY_TOL,
               "launches_per_rank": [r["launches"] for r in res]}
        print(json.dumps({f"tp_rs_f32_vs_one_rank_{phase}": rec}),
              flush=True)
        if not (rec["prefill_max_abs_err"] <= TP_F32_TOL
                and rec["steps_max_abs_err"] <= step_tol
                and math.isfinite(rel) and rel <= TP_FAMILY_TOL
                and rec["m_max_rel_diff"] <= TP_FAMILY_TOL):
            fail(f"phase {phase}: {arch} on a model axis in f32: {rec}")
        if want is not None and any(r["launches"] != want[arch]
                                    for r in res):
            fail(f"phase {phase}: {arch} ranks launched "
                 f"{[r['launches'] for r in res]}, expected {want[arch]} "
                 f"each")
        for r in res:
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
    return total


def headcut_rank(rank):
    """Phase 31 on this rank of phase 10's four, a 1x1x4 grid: 31a's dense
    path (``tp_dense_rank``), 31b's training (``tp_rs_train_rank``) and
    31c-d's answers (``tp_rs_answer_rank``); each sets its counters to
    0."""
    import torch
    from repro_torch.launch.mesh import make_grid, parse_mesh

    arch, B, L_, P = HEADCUT_SERVE
    out = {"31a": tp_dense_rank(rank, HEADCUT_MESH, arch, None, ((B, L_),),
                                P, HEADCUT_GEN, f32_first=True)}
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    grid = make_grid(1, 1, dev, model=parse_mesh(HEADCUT_MESH)[2])
    out["train"] = {arch: tp_rs_train_rank(grid, arch, n, dev,
                                           HEADCUT_TRAIN_KW)
                    for arch, (n, _) in HEADCUT_TRAIN.items()}
    torch.cuda.empty_cache()
    out["answer"] = tp_rs_answer_rank(rank, HEADCUT_ANSWER, HEADCUT_MESH,
                                      turns=True)
    return out


def fallback_rank(rank):
    """Phase 33 on members 0-2 of phase 10's four ranks, a 1x1x3 grid
    (``make_grid(members=)``; rank 3 leaves): each of FALLBACK_SERVE's
    dense paths (``tp_dense_rank``, the f32 prefill of FALLBACK_F32's
    too), 33b's training (``tp_rs_train_rank``) and its f32 answer
    (``tp_rs_answer_rank``), each with its counters from 0 and its wall
    s."""
    import torch
    from repro_torch.launch.mesh import make_grid, parse_mesh

    if rank not in FALLBACK_MEMBERS:
        return None
    out, wall = {}, {}
    dev = torch.device("cuda", 0)
    for name, (arch, n, B, L_) in FALLBACK_SERVE.items():
        t0 = time.perf_counter()
        out[name] = tp_dense_rank(rank, FALLBACK_MESH, arch, n, ((B, L_),),
                                  0, HEADCUT_GEN, name in FALLBACK_F32,
                                  FALLBACK_MEMBERS, FALLBACK_ALIGN)
        torch.cuda.empty_cache()
        wall[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = make_grid(1, 1, dev, model=parse_mesh(FALLBACK_MESH)[2],
                     members=FALLBACK_MEMBERS)
    out["train"] = {arch: tp_rs_train_rank(grid, arch, n, dev,
                                           FALLBACK_TRAIN_KW)
                    for arch, (n, _) in FALLBACK_TRAIN.items()}
    torch.cuda.empty_cache()
    out["answer"] = tp_rs_answer_rank(rank, FALLBACK_ANSWER, FALLBACK_MESH,
                                      turns=True, members=FALLBACK_MEMBERS)
    wall["33b"] = time.perf_counter() - t0
    out["wall_s"] = wall
    return out


def fallback_phase(torch, T, kw, get_config, refs, ranks, smi) -> list:
    """Phase 33's checks, of ``ranks`` (members 0-2's ``fallback_rank``
    results): each served phase against the one-rank run of its model in
    this process (tokens equal; FALLBACK_F32's bf16 logits as 31a's and
    f32 prefill within TP_F32_TOL, the others' bf16 logits within
    LOGIT_TOL; no slot dropped; each rank's flash or WKV launches), 33b's training and its f32 answer (each rank's flash
    launches of the shard runs).  Printed with each sub-phase's wall s
    and the card's name and power limit (``smi``; 33b's one-rank step
    time is not measured here: null).  Returns the ranks' launches."""
    out = []
    for name, (arch, n, B, L_) in FALLBACK_SERVE.items():
        got, _ = tp_rs_serve(torch, T, kw, get_config, name,
                             [r[name] for r in ranks], (arch, B, L_, 0),
                             FALLBACK_MESH, None,
                             quantum=name in FALLBACK_F32,
                             n_gen=HEADCUT_GEN, layers=n)
        out += got
    out += tp_rs_train(get_config, {**refs, **dict.fromkeys(FALLBACK_TRAIN)},
                       [r["train"] for r in ranks], "33b", FALLBACK_TRAIN,
                       FALLBACK_MESH, FALLBACK_TRAIN_KW)
    want = {}
    for arch, n, _, _ in FALLBACK_ANSWER:
        f = flash_per_prefill(cut(get_config, arch, n))
        want[arch] = {"flash_fwd": 3 * f, "flash_bwd_dq": f,
                      "flash_bwd_dkv": f, "wkv": 0}
    out.append(tp_rs_answer([r["answer"] for r in ranks], "33b",
                            FALLBACK_ANSWER, FALLBACK_MESH, want))
    print(json.dumps({"fallback_phase_33": {
        "card": smi, "mesh": FALLBACK_MESH, "members": FALLBACK_MEMBERS,
        "ranks_wall_s": {k: max(r["wall_s"][k] for r in ranks)
                         for k in ranks[0]["wall_s"]}}}), flush=True)
    return out


def headcut_phase(torch, T, kw, get_config, refs, ranks, one) -> list:
    """Phase 31's checks, of ``ranks`` (each rank's ``headcut_rank``
    result): 31a against ``one``, 29a's one-rank run of the same model
    and input; 31b; 31c-d, with each rank's flash launches of the shard
    runs (a prefill, and a training step's two forwards, dq and dk/dv,
    of each attention call).  Returns the ranks' launches."""
    out, _ = tp_rs_serve(torch, T, kw, get_config, "31a",
                         [r["31a"] for r in ranks], HEADCUT_SERVE,
                         HEADCUT_MESH, one, quantum=True,
                         n_gen=HEADCUT_GEN)
    out += tp_rs_train(get_config, refs, [r["train"] for r in ranks], "31b",
                       HEADCUT_TRAIN, HEADCUT_MESH, HEADCUT_TRAIN_KW)
    want = {}
    for arch, n, _, _ in HEADCUT_ANSWER:
        f = flash_per_prefill(cut(get_config, arch, n))
        want[arch] = {"flash_fwd": 3 * f, "flash_bwd_dq": f,
                      "flash_bwd_dkv": f, "wkv": 0}
    for phase in ("31c", "31d"):
        out.append(tp_rs_answer([r["answer"] for r in ranks], phase,
                                HEADCUT_ANSWER, HEADCUT_MESH, want))
    return out


def drawn_params(torch, T, cfg, model, m=None, device="cuda",
                 f32=False) -> dict:
    """Weights of ``cfg`` from INSIDE_SEED, drawn part by part: each leaf
    that a model axis of ``model`` cuts (``sharding.param_model_dims``) as
    its ``model`` parts along its dim, each from a generator of its own,
    a whole leaf from one.  Rank ``m``'s shard draws its parts only; the
    whole model (``m`` None) draws every part and concatenates them: the
    same numbers, and no rank holds more than its shard.  The leaves'
    shapes and dtypes are ``init_model``'s (f32 with ``f32``), their
    distributions its kinds: U(-1/sqrt(fan-in), 1/sqrt(fan-in)), the
    embedding N(0, 1/D), the norms 0."""
    import zlib

    from repro_torch.models.sharding import param_model_dims

    meta = T.init_model(cfg, device="meta")
    dims = param_model_dims(meta, model, cfg)

    def draw(path, t, d):
        shape = list(t.shape)
        if d >= 0:
            shape[d] //= model
        parts = [0] if d < 0 else range(model) if m is None else [m]
        dt = torch.float32 if f32 else t.dtype
        out = []
        for i in parts:
            gen = torch.Generator(device=device).manual_seed(
                INSIDE_SEED * 1_000_003 + zlib.crc32(path.encode()) * 97 + i)
            if t.dim() == 1:
                x = torch.zeros(shape, device=device)
            elif path == "embed":
                x = torch.randn(shape, generator=gen, device=device).div_(
                    math.sqrt(cfg.d_model))
            else:
                x = torch.rand(shape, generator=gen, device=device).mul_(
                    2.0).sub_(1.0).mul_(1.0 / math.sqrt(t.shape[-2]))
            out.append(x.to(dt))
        return out[0] if len(out) == 1 else torch.cat(out, d)

    def walk(tree, dim, path):
        if isinstance(tree, dict):
            return {k: walk(v, dim[k], f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, d, f"{path}/{i}")
                    for i, (v, d) in enumerate(zip(tree, dim))]
        return draw(path, tree, dim)

    return walk(meta, dims, "")


def paged_serve(torch, T, cfg, params, B, L, tp=None, gen=INSIDE_GEN,
                block=INSIDE_BLOCK) -> dict:
    """The paged path of ``dense_serve``'s prompt: its prefill (the cache
    at full length, of the rank's KV heads on a model axis ``tp``)
    scattered into block pools, then greedy steps of
    ``decode_step_paged`` to ``gen`` tokens.  Returns the tokens, each
    step's logits, the wall times and the collectives of each call."""
    dev = params["embed"].device
    inputs = {k: v.to(dev)
              for k, v in prompt_inputs(torch, cfg, B, L, 0, L).items()}
    calls = (lambda: tp.calls) if tp is not None else (lambda: 0)
    nb = -(-(L + gen) // block)
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    sync()
    t0 = time.perf_counter()
    c0 = calls()
    lg, cache, _ = T.prefill(params, cfg, inputs, L, full_local_cache=True,
                             tp=tp, seq_shard=False)
    c1 = calls()
    pools = T.init_paged_pools(cfg, 1 + B * nb, block, device=dev, tp=tp)
    tables = torch.arange(1, 1 + B * nb, device=dev).reshape(B, nb)
    for b in range(B):
        T.scatter_prefill_cache(pools, cache, tables[b, :L // block].tolist(),
                                block, row=b)
    del cache
    out, lgs = [lg[:, -1].argmax(-1, keepdim=True)], [lg]
    sync()
    t1 = time.perf_counter()
    c2 = calls()
    for i in range(gen - 1):
        pos = torch.full((B,), L + i, device=dev)
        lg, pools = T.decode_step_paged(params, cfg, pools, tables, out[-1],
                                        pos, tp=tp)
        out.append(lg[:, -1].argmax(-1, keepdim=True))
        lgs.append(lg)
    sync()
    t2 = time.perf_counter()
    return {"prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_step": (t2 - t1) * 1e3 / (gen - 1),
            "tokens": torch.cat(out, 1), "logits": lgs,
            "collectives_prefill": c1 - c0,
            "collectives_per_decode_step": (calls() - c2) / (gen - 1)}


def inside_batch(torch, cfg, device) -> dict:
    """34b's (B, S) tokens and next-token labels from a seed."""
    _, (B, S) = INSIDE_TRAIN
    t = torch.randint(0, cfg.vocab, (B, S + 1),
                      generator=torch.Generator().manual_seed(INSIDE_SEED))
    return {"tokens": t[:, :-1].to(device), "labels": t[:, 1:].to(device)}


EXPERT_LEAVES = ("w_in", "w_gate", "w_out")


def served(run) -> dict:
    """What a rank returns of a ``dense_serve``/``paged_serve`` run."""
    return {"tokens": run["tokens"].cpu().numpy(),
            "first_logits": run["logits"][0].float().cpu().numpy(),
            "finite": all(bool(x.isfinite().all()) for x in run["logits"]),
            **{k: run[k] for k in ("prefill_ms", "decode_ms_per_step",
                                   "collectives_prefill",
                                   "collectives_per_decode_step")}}


def inside_rank(rank):
    """Phase 34 on this rank of INSIDE_MODEL forked for it, a 1x1x32 grid
    sharing the card (gloo): its shard of 34a's model (``drawn_params``),
    the dense and the paged path with the counters from 0 (and the bytes
    each staged), the same shard's f32 prefill (uncounted), then 34b's
    one f32 ``loss_and_grads`` of 1 layer with the counters from 0: the
    loss, the axis's collectives, the launches, and of each expert leaf
    its largest |gradient| and INSIDE_SAMPLE rows of every expert."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv as kw
    from repro_torch.launch.mesh import make_grid
    from repro_torch.launch.step import loss_and_grads, make_prefill_fn
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    grid = make_grid(1, 1, dev, model=INSIDE_MODEL)
    tp = grid.tp
    cfg = cut(get_config, INSIDE_ARCH, INSIDE_LAYERS)
    B, L_ = INSIDE_PROMPT
    params = drawn_params(torch, T, cfg, INSIDE_MODEL, tp.index, dev)
    reset(fa, kw)
    torch.cuda.reset_peak_memory_stats(dev)
    s0 = grid.staged_bytes
    dense = served(dense_serve(torch, cfg, params, B, L_, grid=grid,
                               align=INSIDE_MODEL, gen=INSIDE_GEN))
    s1 = grid.staged_bytes
    paged = served(paged_serve(torch, T, cfg, params, B, L_, tp))
    out = {"dense": dense, "paged": paged, "launches": counts(fa, kw),
           "staged_bytes": [s1 - s0, grid.staged_bytes - s1],
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    params = tree_map(lambda t: t.float(), params)
    ins = {k: v.cuda()
           for k, v in prompt_inputs(torch, cfg, B, L_, 0, L_).items()}
    s_max = L_ + INSIDE_GEN - 1
    lg, _, _ = make_prefill_fn(cfg, s_max + (-s_max) % INSIDE_MODEL, grid)(
        params, ins)
    out["f32_first_logits"] = lg.float().cpu().numpy()
    del params, lg
    torch.cuda.empty_cache()
    n, _ = INSIDE_TRAIN
    cfg1 = cut(get_config, INSIDE_ARCH, n)
    p1 = drawn_params(torch, T, cfg1, INSIDE_MODEL, tp.index, dev, f32=True)
    batch = inside_batch(torch, cfg1, dev)
    reset(fa, kw)
    calls = {}
    loss, grads = loss_and_grads(p1, cfg1, batch, tp, calls)
    mlp = grads["layers"][0]["mlp"]
    out["train"] = {
        "loss": loss.item(), "calls": calls, "launches": counts(fa, kw),
        "grad_max": {k: mlp[k].abs().max().item() for k in EXPERT_LEAVES},
        "grad_sample": {k: mlp[k][:, :INSIDE_SAMPLE].cpu().numpy()
                        for k in EXPERT_LEAVES}}
    del p1, grads, mlp
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_start
    return out


def inside_phase(torch, T, fa, kw, get_config, smi, wkv_ptxas) -> dict:
    """Phase 34: the memory reckoned and printed, the one-rank runs of 34a
    (bf16 dense and paged paths, the f32 prefill) and 34b (f32, 1 layer)
    on the whole drawn model in this process, freed, then INSIDE_MODEL
    ranks forked (``inside_rank``) and held to them; 34c.  Returns the
    flash launches of the phase's runs, the ranks' and this process's."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.step import loss_and_grads
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    M = INSIDE_MODEL
    cfg = cut(get_config, INSIDE_ARCH, INSIDE_LAYERS)
    B, L_ = INSIDE_PROMPT
    params = drawn_params(torch, T, cfg, M)
    numel = sum(t.numel() for t in tree_leaves(params))
    layer = sum(t.numel() for t in tree_leaves(params["layers"][0]))
    print(json.dumps({"inside_memory_reckoning": {
        "arch": INSIDE_ARCH, "layers": cfg.n_layers,
        "params_per_layer": layer, "embedding": params["embed"].numel(),
        "params": numel, "bf16_gb": 2 * numel / 1e9,
        "f32_gb": 4 * numel / 1e9, "ranks": M,
        "bf16_gb_per_rank": 2 * numel / M / 1e9,
        "f32_gb_per_rank": 4 * numel / M / 1e9}}), flush=True)
    reset(fa, kw)
    one = {"dense": served(dense_serve(torch, cfg, params, B, L_, align=M,
                                       gen=INSIDE_GEN)),
           "paged": served(paged_serve(torch, T, cfg, params, B, L_))}
    one_launches = counts(fa, kw)
    params = tree_map(lambda t: t.float(), params)
    ins = {k: v.cuda()
           for k, v in prompt_inputs(torch, cfg, B, L_, 0, L_).items()}
    s_max = L_ + INSIDE_GEN - 1
    f32, _, _ = T.prefill(params, cfg, ins, s_max + (-s_max) % M)
    f32 = f32.float().cpu().numpy()
    del params
    torch.cuda.empty_cache()
    n, _ = INSIDE_TRAIN
    cfg1 = cut(get_config, INSIDE_ARCH, n)
    p1 = drawn_params(torch, T, cfg1, M, None, "cuda", f32=True)
    batch = inside_batch(torch, cfg1, "cuda")
    reset(fa, kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss, grads = loss_and_grads(p1, cfg1, batch)
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t1) * 1e3
    one_train = counts(fa, kw)
    mlp = grads["layers"][0]["mlp"]
    ref_max = {k: mlp[k].abs().max().item() for k in EXPERT_LEAVES}
    ref = {k: mlp[k][:, :INSIDE_SAMPLE].cpu().numpy() for k in EXPERT_LEAVES}
    loss = loss.item()
    del p1, grads, mlp
    torch.cuda.empty_cache()
    t_one = time.perf_counter() - t0

    t1 = time.perf_counter()
    ranks = run_ranks(inside_rank, M, "gloo", (), timeout=900.0)
    t_ranks = time.perf_counter() - t1

    # 34a
    top = float(abs(f32).max())
    tol = max(LOGIT_TOL, 2.0 ** (math.floor(math.log2(top)) - 7))
    rec = {"card": smi, "arch": INSIDE_ARCH, "layers": cfg.n_layers,
           "mesh": f"1x1x{M}", "prompt": list(INSIDE_PROMPT),
           "generated": INSIDE_GEN, "one_rank_wall_s": t_one,
           "ranks_wall_s": t_ranks,
           "rank_body_wall_s_max": max(r["wall_s"] for r in ranks),
           "staged_bytes_rank0": ranks[0]["staged_bytes"],
           "peak_mem_gb_per_rank_max": max(r["peak_mem_gb"] for r in ranks),
           "one_rank_launches": one_launches,
           "rank_launches": ranks[0]["launches"], "logit_tol": tol,
           "max_abs_logit_f32": top}
    for path in ("dense", "paged"):
        got = [r[path] for r in ranks]
        want = one[path]
        if not all(g["finite"] for g in got) or not want["finite"]:
            fail(f"phase 34a {path}: non-finite logits")
        for m, g in enumerate(got):
            if (g["tokens"] != want["tokens"]).any():
                fail(f"phase 34a {path}: rank {m}'s tokens "
                     f"{g['tokens'].tolist()} differ from one rank's "
                     f"{want['tokens'].tolist()}")
        err = max(float(abs(g["first_logits"] - want["first_logits"]).max())
                  for g in got)
        calls = {"prefill": INSIDE_CALLS[f"{path}_prefill"](cfg.n_layers),
                 "step": INSIDE_CALLS[f"{path}_step"](cfg.n_layers)}
        seen = {"prefill": sorted({g["collectives_prefill"] for g in got}),
                "step": sorted({g["collectives_per_decode_step"]
                                for g in got})}
        rec[path] = {
            "tokens": want["tokens"].tolist(),
            "first_prefill_max_abs_logit_err_bf16": err,
            "prefill_wall_ms": max(g["prefill_ms"] for g in got),
            "decode_wall_ms_per_step": max(g["decode_ms_per_step"]
                                           for g in got),
            "one_rank_prefill_wall_ms": want["prefill_ms"],
            "one_rank_decode_wall_ms_per_step": want["decode_ms_per_step"],
            "collectives_predicted": calls, "collectives": seen}
        if err > tol:
            fail(f"phase 34a {path}: bf16 first logits {err} from one "
                 f"rank's, bound {tol}")
        if seen != {k: [v] for k, v in calls.items()}:
            fail(f"phase 34a {path}: collectives {seen}, predicted {calls}")
    err = max(float(abs(r["f32_first_logits"] - f32).max()) for r in ranks)
    rec["f32_first_prefill_max_abs_err"] = err
    if not err <= TP_F32_TOL:
        fail(f"phase 34a: f32 prefill {err} from one rank's, bound "
             f"{TP_F32_TOL}")
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "wkv": 0}
    for m, r in enumerate(ranks):
        if r["launches"] != want:
            fail(f"phase 34a: rank {m} launched {r['launches']}, expected "
                 f"{want}")

    # 34b
    tr = [r["train"] for r in ranks]
    rel = abs(tr[0]["loss"] - loss) / abs(loss)
    g_err = {}
    for k in EXPERT_LEAVES:
        w = tr[0]["grad_sample"][k].shape[-1]
        g_err[k] = max(float(abs(t["grad_sample"][k]
                                 - ref[k][..., m * w:(m + 1) * w]).max())
                       for m, t in enumerate(tr)) / ref_max[k]
        g_err[k + "_max"] = abs(max(t["grad_max"][k] for t in tr)
                                - ref_max[k]) / ref_max[k]
    want_calls = INSIDE_CALLS["train"](n)
    want = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "wkv": 0}
    rec["34b"] = {"layers": n, "batch_seq": list(INSIDE_TRAIN[1]),
                  "loss": tr[0]["loss"], "one_rank_loss": loss,
                  "loss_rel_err": rel, "grad_err_over_max": g_err,
                  "one_rank_step_ms": train_ms,
                  "calls": tr[0]["calls"], "calls_predicted": want_calls,
                  "launches": tr[0]["launches"],
                  "one_rank_launches": one_train}
    print(json.dumps({"inside_phase_34": rec}), flush=True)
    if any(t["loss"] != tr[0]["loss"] for t in tr) or not rel <= 1e-5:
        fail(f"phase 34b: losses {sorted({t['loss'] for t in tr})} against "
             f"one rank's {loss}")
    if not all(v <= TP_FAMILY_TOL for v in g_err.values()):
        fail(f"phase 34b: expert gradients {g_err} over their largest "
             f"entry, bound {TP_FAMILY_TOL}")
    for m, t in enumerate(tr):
        if t["calls"] != want_calls or t["launches"] != want:
            fail(f"phase 34b: rank {m} made {t['calls']} collectives and "
                 f"{t['launches']} launches, predicted {want_calls} and "
                 f"{want}")

    # 34c
    wkv_phase(torch, kw, INSIDE_WKV, wkv_ptxas)
    total = {k: sum(r["launches"][k] + r["train"]["launches"][k]
                    for r in ranks) + one_launches[k] + one_train[k]
             for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    print(json.dumps({"inside_phase_34_launches": total}), flush=True)
    return total


def dry_runs(path: str) -> None:
    """Phase 32's dry runs, on the CPU (``--dry-runs PATH``, the
    subprocess main starts): 32a-b the one-rank training steps of phases
    7, 26a and 27a, 32c every rank of 31b's cell; written to ``path`` as
    JSON."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import run_rank
    from repro_torch.launch.mesh import parse_mesh

    t0 = time.perf_counter()
    shape = lambda kw_: ShapeSpec("custom", "train", kw_["seq"],
                                  kw_["batch"])
    out = {}
    for phase, (arch, n, kw_) in DRY_TRAIN.items():
        r = run_rank(cut(get_config, arch, n), shape(kw_), 1, 1, 1)
        out[phase] = {"arch": arch, **kw_, "memory": r["memory"],
                      "gflops": r["flops"] / 1e9, "gbytes": r["bytes"] / 1e9,
                      "kernels": r["kernels"], "trace_s": r["trace_s"]}
    (arch, (n, _)), = HEADCUT_TRAIN.items()
    M = parse_mesh(HEADCUT_MESH)[2]
    out["32c"] = [run_rank(cut(get_config, arch, n),
                           shape(HEADCUT_TRAIN_KW), 1, 1, M, m)["calls"]
                  for m in range(M)]
    out["wall_s"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(out, f)


def start_dry_runs() -> tuple:
    """Start :func:`dry_runs` in a CPU subprocess (no card visible to it);
    it is killed if this script ends first."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dry_"))
    log = open(tmp / "log.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dry-runs",
         str(tmp / "dry.json")], stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, tmp


def dry_phase(proc, tmp, pool4) -> None:
    """32: the dry runs against the card (phases 7, 26a, 27a and 31b)."""
    try:
        rc = proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail("phase 32: the dry runs took more than 300 s")
    if rc:
        fail(f"phase 32: the dry runs failed:\n"
             f"{(tmp / 'log.txt').read_text()[-3000:]}")
    dry = json.loads((tmp / "dry.json").read_text())
    shutil.rmtree(tmp, ignore_errors=True)
    for phase, key in (("32a", "7"), ("32b", "26a"), ("32b", "27a")):
        d = dry[key]
        gb = d["memory"]["bytes_per_device"] / 1e9
        ratio = gb / PEAK_GB[key]
        print(json.dumps({f"dry_run_{phase}_{key}": {
            **d, "bytes_per_device_gb": gb, "card_peak_gb": PEAK_GB[key],
            "dry_over_card": ratio,
            "breakdown_gb": {k: v / 1e9 for k, v in d["memory"].items()}}}),
            flush=True)
        if phase == "32a" and not DRY_MEM_RATIO[0] <= ratio \
                <= DRY_MEM_RATIO[1]:
            fail(f"phase 32a: the dry run holds {gb:.3f} GB, the card "
                 f"{PEAK_GB[key]:.3f} GB at most: {ratio:.3f} outside "
                 f"{DRY_MEM_RATIO}")
    arch = next(iter(HEADCUT_TRAIN))
    for m, r in enumerate(pool4):
        for i, got in enumerate(r["31"]["train"][arch]["axes"]):
            if got != dry["32c"][m]:
                fail(f"phase 32c: rank {m} step {i} counted {got} on the "
                     f"card, the dry run {dry['32c'][m]}")
    print(json.dumps({"dry_run_32c": {
        "mesh": HEADCUT_MESH, "per_rank": dry["32c"],
        "equal_on_card": True, "dry_runs_wall_s": dry["wall_s"]}}),
        flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-wkv", metavar="LIB", action="append",
                    default=[], help="a shared library built from an "
                    "earlier csrc/wkv.cu, timed in turns with this one "
                    "under its file name (repeatable)")
    ap.add_argument("--dry-runs", metavar="PATH", help="run phase 32's "
                    "dry runs on the CPU, write them to PATH and exit "
                    "(the subprocess the script starts)")
    ap.add_argument("--phase-33", action="store_true", help="build the "
                    "kernels, run phase 33 alone on three ranks of its own "
                    "and exit (no result line)")
    ap.add_argument("--phase-34", action="store_true", help="build the "
                    "kernels, run phase 3's shape of phase 34 and phase 34 "
                    "alone and exit (no result line)")
    ap.add_argument("--phase-35", action="store_true", help="build the "
                    "kernels, check their SASS, run phase 35 alone and "
                    "exit (no result line)")
    ap.add_argument("--phase-36", action="store_true", help="build the "
                    "kernels, run phase 36 alone and exit (no result "
                    "line)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not KERNELS.is_dir():
        fail(f"{KERNELS} not found: run from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    if args.dry_runs:
        dry_runs(args.dry_runs)
        return
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    dry_proc, dry_tmp = start_dry_runs()
    # the ranks' fork server imports while the kernels build
    from repro_torch.launch.mesh import preload_ranks
    preload_ranks(*RANK_PRELOAD)
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
    from repro_torch.kernels import wkv as kw
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving import ReqState

    progress("2", t_start)
    # 2. build
    t0 = time.perf_counter()
    logs = backend.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  {name}: {line.strip()}")
    if args.phase_33:
        from repro_torch.launch.mesh import run_ranks

        t0 = time.perf_counter()
        ranks = run_ranks(fallback_rank, len(FALLBACK_MEMBERS), "gloo", (),
                          timeout=900.0)
        fallback_phase(torch, T, kw, get_config, {}, ranks,
                       smi.splitlines()[0])
        print(json.dumps({"phase_33_alone_wall_s":
                          time.perf_counter() - t0}), flush=True)
        return
    wkv_ptxas = ptxas_of(logs.get("wkv", ""), "wkv_kernel")
    print(json.dumps({"wkv_ptxas": wkv_ptxas}), flush=True)
    print(json.dumps({"flash_ptxas": {
        f"{kern}_kernel": ptxas_of(logs.get(src, ""), f"{kern}_kernel")
        for src, kern in (("flash_fwd", "flash_fwd"),
                          ("flash_fwd", "flash_fwd_bf16"),
                          ("flash_bwd", "flash_bwd_dq"),
                          ("flash_bwd", "flash_bwd_dq_bf16"),
                          ("flash_bwd", "flash_bwd_dkv"),
                          ("flash_bwd", "flash_bwd_dkv_bf16"))}}), flush=True)
    if args.phase_36:
        t0 = time.perf_counter()
        wkv_width_phase(torch, kw, wkv_ptxas, get_config)
        print(json.dumps({"phase_36_alone_wall_s":
                          time.perf_counter() - t0}), flush=True)
        return
    if args.phase_34:
        t0 = time.perf_counter()
        flash_phase(torch, fa, SHAPES[-1])
        inside_phase(torch, T, fa, kw, get_config, smi.splitlines()[0],
                     wkv_ptxas)
        print(json.dumps({"phase_34_alone_wall_s":
                          time.perf_counter() - t0}), flush=True)
        return
    mma = {**tensor_core_ops(backend.sass("flash_fwd")),
           **tensor_core_ops(backend.sass("flash_bwd"))}
    print(json.dumps({"flash_sass_hmma": mma}), flush=True)
    want = {f"flash_{k}_bf16 hd {d} {e}"
            for k in ("fwd", "bwd_dq", "bwd_dkv")
            for d in fa.KERNEL_HEAD_WIDTHS for e in ("exact", "padded")}
    bf16 = {k: n for k, n in mma.items() if "_bf16 " in k}
    if set(bf16) != want or not all(bf16.values()):
        fail(f"the bf16 flash kernels' SASS holds {bf16} tensor-core "
             f"instructions, expected a nonzero count for each of "
             f"{sorted(want)}")
    if args.phase_35:
        t0 = time.perf_counter()
        width_phase(torch, fa, kw, L)
        print(json.dumps({"phase_35_alone_wall_s":
                          time.perf_counter() - t0}), flush=True)
        return

    progress("3-4", t_start)
    # 3-4. kernels against their plain versions
    recs = [flash_phase(torch, fa, s) for s in SHAPES]
    bwd = {i: flash_bwd_phase(torch, fa, s)
           for i, s in enumerate(SHAPES) if i in BWD_SHAPES}

    progress("35", t_start)
    # 35. the head dims between the kernels' tile widths
    width_counts = width_phase(torch, fa, kw, L)

    progress("5", t_start)
    # 5. the serving path
    reset(fa, kw)
    runs = serve_runs(serve)
    serve_counts = counts(fa, kw)
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
    if serve_counts != {"flash_fwd": cfg.n_layers * prefills,
                        "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "wkv": 0} \
            or prefills != 9:
        fail(f"serving launched {serve_counts} for {prefills} prefills of "
             f"{cfg.n_layers} layers")

    progress("17", t_start)
    # 17. serving with the network plane, in turns with phase 5
    net_counts = net_serve_phase(serve, fa, kw, runs, cfg)

    progress("6", t_start)
    # 6. the serving answer: f32 weights, the card against the CPU
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
    del params, p_gpu, p_cpu

    progress("7", t_start)
    # 7. the training path
    reset(fa, kw)
    torch.cuda.reset_peak_memory_stats()
    tr = train("gpt-100m", device="cuda", log_every=1, **TRAIN)
    train_counts = counts(fa, kw)
    steady = tr["step_ms"][1:]
    PEAK_GB["7"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"train": {
        **TRAIN, "losses": tr["losses"], "step_ms": tr["step_ms"],
        "steady_step_ms_mean": sum(steady) / len(steady),
        "tokens_per_s": tr["tokens_per_s"], "launches": train_counts,
        "peak_mem_gb": PEAK_GB["7"]}}), flush=True)
    if not all(math.isfinite(x) for x in tr["losses"]) \
            or len(tr["losses"]) != TRAIN["steps"]:
        fail(f"training losses {tr['losses']}")
    per_step = cfg.n_layers * TRAIN["steps"]
    want = {"flash_fwd": 2 * per_step, "flash_bwd_dq": per_step,
            "flash_bwd_dkv": per_step, "wkv": 0}
    if train_counts != want:
        fail(f"training launched {train_counts}, expected {want}")

    progress("8", t_start)
    # 8. the training answer: f32, the card against the CPU
    train_answer(torch, get_config)

    progress("9", t_start)
    # 9. the int8 kernels against their plain versions
    quant = quant_phase(torch)

    progress("10", t_start)
    # 10. the collectives on four ranks sharing the card.  Each spawn
    # costs seconds a rank before any work, so the ranks of phases 10, 12,
    # 24d, 25c's 2x1x2 grid and 26f are one spawn (``pool4_rank``): fresh
    # processes whose counters start at 0, each body setting its own to 0
    # before it runs; 24d's one-rank runs, whose caches its ranks take,
    # come first
    from repro_torch.launch.mesh import run_ranks

    tp_ones, tp_jobs = tp_answer_ones(torch, T, get_config)
    torch.cuda.empty_cache()
    pool4 = run_ranks(pool4_rank, 4, "gloo", (tp_jobs,), timeout=900.0)
    coll = collectives_phase(torch, pool4)

    progress("11", t_start)
    # 11. the grid's training path: each rank is a fresh process whose
    # counters start at 0; train returns every rank's counts at its end
    torch.cuda.reset_peak_memory_stats()
    gt = train("gpt-100m", device="cuda", log_every=1, **GRID_TRAIN)
    steps = GRID_TRAIN["steps"]
    per_step = [{k: v / steps for k, v in r.items()} for r in gt["launches"]]
    print(json.dumps({"grid_train": {
        **GRID_TRAIN, "world": gt["world"], "backend": gt["backend"],
        "staging": gt["staging"], "losses": gt["losses"],
        "step_ms": gt["step_ms"], "tokens_per_s": gt["tokens_per_s"],
        "staged_bytes_per_step": gt["staged_bytes"],
        "slow_wire_bytes_per_step": gt["slow_wire_bytes"],
        "slow_f32_bytes_per_step": gt["slow_f32_bytes"],
        "launches_per_rank_per_step": per_step}}), flush=True)
    if not all(math.isfinite(x) for x in gt["losses"]) \
            or len(gt["losses"]) != steps:
        fail(f"grid training losses {gt['losses']}")
    leaves = 10                  # the reference's stacked leaves of gpt-100m
    want = {"wkv": 0, "flash_fwd": 2 * cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps,
            "flash_bwd_dkv": cfg.n_layers * steps, "quantize_int8": 0,
            "dequantize_int8": leaves * steps,
            "quantize_ef_int8": leaves * steps}
    for r, got in enumerate(gt["launches"]):
        if got != want:
            fail(f"grid training rank {r} launched {got}, expected {want}")
    grid_counts = {k: sum(r[k] for r in gt["launches"]) for k in want}

    progress("12", t_start)
    # 12. the grid's answer: f32, four ranks on the card against four on
    # the CPU (phase 10's spawn)
    grid_answer(pool4)

    progress("13", t_start)
    # 13. the WKV kernel against its plain version
    parents = {Path(p).stem: parent_wkv(p) for p in args.parent_wkv}
    wkv_recs = [wkv_phase(torch, kw, s, wkv_ptxas,
                          parents if i in WKV_TURNS else None)
                for i, s in enumerate(WKV_SHAPES)]
    refit_phase()

    progress("14", t_start)
    # 14. the RWKV-6 serving path
    rcfg = get_config("rwkv6-1.6b")
    params = T.init_model(rcfg, seed=0, device="cuda")
    reset(fa, kw)
    rruns = [dense_serve(torch, rcfg, params, B, L) for B, L in RWKV_SERVE]
    rwkv_counts = counts(fa, kw)
    for (B, L), r in zip(RWKV_SERVE, rruns):
        gen = r["tokens"]
        if gen.shape != (B, DENSE_GEN) or gen.min() < 0 \
                or gen.max() >= rcfg.vocab \
                or not all(torch.isfinite(x).all() for x in r["logits"]):
            fail(f"rwkv6 served tokens of shape {tuple(gen.shape)} or "
                 f"non-finite logits")
        print(json.dumps({"rwkv6_serve": {
            "batch": B, "prompt": L, "generated": DENSE_GEN,
            "prefill_wall_ms": r["prefill_ms"],
            "decode_wall_ms_per_step": r["decode_ms_per_step"],
            "tokens_per_s": B * DENSE_GEN / r["wall_s"]}}), flush=True)
    want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "wkv": rcfg.n_layers * len(RWKV_SERVE)}
    if rwkv_counts != want:
        fail(f"rwkv6 serving launched {rwkv_counts}, expected {want}")
    del params, rruns

    progress("15", t_start)
    # 15. the RWKV-6 answer: f32, the card against the CPU
    rwkv_answer(torch, get_config)

    progress("36", t_start)
    # 36. the WKV kernel at the other head dims and chunk lengths
    wide_wkv = wkv_width_phase(torch, kw, wkv_ptxas, get_config)

    progress("16", t_start)
    # 16. the seven collectives by tree on eight ranks sharing the card;
    # each rank is a fresh process whose counters start at 0
    tree, disc = tree_phase(torch)

    progress("18", t_start)
    # 18. the train launcher's planning on a grid: each rank is a fresh
    # process whose counters start at 0
    bucket_counts = bucket_train_phase(train, cfg)

    progress("19", t_start)
    # 19. discovery on phase 16's ranks
    discovery_phase(torch, disc)

    progress("20", t_start)
    # 20. elastic training on ranks sharing the card: each rank is a fresh
    # process whose counters start at 0
    elastic_counts = elastic_phase(train, get_config)

    progress("21", t_start)
    # 21. the MoE main path: olmoe-1b-7b through the paged scheduler
    from repro_torch.models import layers as L
    walls = [time.perf_counter()]
    moe_counts, moe_runs = moe_serve_phase(torch, serve, fa, kw, T, L,
                                           get_config)
    walls.append(time.perf_counter())

    progress("22", t_start)
    # 22. the dense path: recurrentgemma, seamless, pixtral, llama4-scout
    dense_flash = dense_serve_phase(torch, fa, kw, T, get_config)
    walls.append(time.perf_counter())

    progress("23", t_start)
    # 23. the new configs' f32 answer, the card against the CPU
    arch_answer(torch, T, L, get_config)
    walls.append(time.perf_counter())

    progress("24", t_start)
    # 24. serving on a model axis: each rank is a fresh process whose
    # counters start at 0 and are read at its end.  The two ranks of 24c,
    # 25c's 1x1x2 and 2x1x1 grids, 27d and phase 28 are one spawn
    # (``tp_rs_rank``), as phase 10's four are
    tp_flash = sum(tp_serve_phase(serve, "gpt-100m", mesh, runs, cfg)
                   for mesh in TP_SERVE)
    tp_flash += tp_serve_phase(serve, MOE_ARCH, TP_MOE_MESH, moe_runs,
                               get_config(MOE_ARCH))
    walls.append(time.perf_counter())
    torch.cuda.empty_cache()
    ranks = run_ranks(tp_rs_rank, 2, "gloo", (), timeout=900.0)
    walls.append(time.perf_counter())
    tp_flash += tp_dense_phase(torch, T, get_config,
                               [r["24c"] for r in ranks])
    walls.append(time.perf_counter())
    tp_answer_phase(get_config, tp_ones, [r["24d"] for r in pool4])
    walls.append(time.perf_counter())

    progress("25", t_start)
    # 25. training on a model axis: each rank is a fresh process whose
    # counters start at 0 and are read at its end
    refs = {"7": sum(tr["step_ms"][1:]) / len(tr["step_ms"][1:]),
            "11": sum(gt["step_ms"][1:]) / len(gt["step_ms"][1:])}
    tp_train_launches = []
    for name, kw_ in TP_TRAIN.items():
        tp_train_launches += tp_train_case(train, name, kw_, cfg, refs)
        walls.append(time.perf_counter())
    tp_train_answer(torch, T, get_config,
                    {2: ranks[0]["25c"], 4: pool4[0]["25c"]})
    walls.append(time.perf_counter())
    tp_train_launches += tp_train_qwen(torch, train, get_config)
    walls.append(time.perf_counter())
    tp_train_counts = {k: sum(r[k] for r in tp_train_launches)
                       for k in tp_train_launches[0]}

    progress("26", t_start)
    # 26. training the MoE, RG-LRU, enc-dec and frontend configs: 26a-d
    # in this process, counters from 0 before each; 26f's ranks are fresh
    # processes whose counters start at 0 and are read at their end
    family, family_ms = [], {}
    for name in FAMILY_TRAIN:
        got, family_ms[name] = family_train_case(torch, train, fa, kw, L,
                                                 get_config, name)
        family.append(got)
        walls.append(time.perf_counter())
    family_answer(torch, T, fa, kw, get_config)
    walls.append(time.perf_counter())
    family += family_grid(torch, get_config, [r["26f"] for r in pool4])
    walls.append(time.perf_counter())
    family_counts = {k: sum(r[k] for r in family)
                     for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    family_counts.update({k: sum(r.get(k, 0) for r in family) for k in (
        "dequantize_int8", "quantize_ef_int8")})

    progress("27", t_start)
    # 27. training RWKV-6 on one rank (27a-b in this process, counters
    # from 0 before each), and the MoE and the frontend on a model axis
    # (27c-d's ranks are fresh processes whose counters start at 0 and
    # are read at their end)
    rwkv_train, rwkv_ms = rwkv_train_case(torch, train, fa, kw, get_config)
    walls.append(time.perf_counter())
    arch, n = RWKV_TRAIN_ANSWER
    rwkv_answer_counts = answer_step(torch, T, fa, kw,
                                     cut(get_config, arch, n), arch, n,
                                     "rwkv_train_f32_card_vs_cpu", "27b")
    if rwkv_answer_counts["wkv"] != 2 * n:
        fail(f"phase 27b: the card's step launched {rwkv_answer_counts}")
    walls.append(time.perf_counter())
    tp_moe = tp_moe_train(torch, train, get_config, family_ms["26c"])
    walls.append(time.perf_counter())
    # 27d's ranks are phase 24's (``tp_rs_rank``)
    tp_family = tp_family_answer(get_config, [r["27d"] for r in ranks])
    walls.append(time.perf_counter())
    tp_counts = {k: sum(r[k] for r in tp_moe) + tp_family[k]
                 for k in tp_family}

    # 28. RWKV-6 and the enc-dec config, and 29. the RG-LRU family and
    # the KV-head split, on a model axis, on the ranks that phase 24
    # spawned (``tp_rs_rank``)
    refs = {}
    for arch, phase, kw_ in (("rwkv6-1.6b", "27a", RWKV_TRAIN),
                             ("seamless-m4t-medium", "26b",
                              FAMILY_TRAIN["26b"][2]),
                             ("recurrentgemma-2b", "26a",
                              FAMILY_TRAIN["26a"][2])):
        ms = rwkv_ms if phase == "27a" else family_ms[phase]
        layers = get_config(arch).n_layers
        refs[arch] = {"phase": phase, **kw_, "layers": layers, "ms": ms,
                      "ms_scaled_to_layers": ms * TP_RS_TRAIN[arch][0]
                      / layers}
    tp_rs, ones = [], {}
    for phase, answer, training in (("28", "28d", "28c"),
                                    ("29", "29c", "29b")):
        progress(phase, t_start)
        for name in TP_RS_SERVE:
            if name.startswith(phase):
                got, ones[name] = tp_rs_serve(torch, T, kw, get_config, name,
                                              [r[name] for r in ranks])
                tp_rs += got
        tp_rs.append(tp_rs_answer([r["answer"] for r in ranks], answer))
        tp_rs += tp_rs_train(get_config, refs, [r["train"] for r in ranks],
                             training)
        walls.append(time.perf_counter())
    del ranks

    progress("30", t_start)
    # 30. elastic training on a model axis: train spawns its six ranks
    tp_elastic_counts = tp_elastic_phase(train, get_config)
    walls.append(time.perf_counter())

    progress("31", t_start)
    # 31. a model axis that cuts inside a head, and a vocabulary it does
    # not divide: phase 10's ranks computed it (``headcut_rank``)
    tp_rs += headcut_phase(torch, T, kw, get_config, refs,
                           [r["31"] for r in pool4], ones["29a"])
    del ones
    walls.append(time.perf_counter())

    progress("32", t_start)
    # 32. the dry run against the card, computed in the subprocess started
    # at the beginning
    dry_phase(dry_proc, dry_tmp, pool4)
    walls.append(time.perf_counter())

    progress("33", t_start)
    # 33. a model axis of 3 through the reference's fallback placements:
    # members 0-2 of phase 10's ranks computed it (``fallback_rank``)
    tp_rs += fallback_phase(torch, T, kw, get_config, refs,
                            [r["33"] for r in pool4[:3]],
                            smi.splitlines()[0])
    walls.append(time.perf_counter())

    progress("34", t_start)
    # 34. the cuts inside a unit on a model axis of 32 ranks forked for it
    inside = inside_phase(torch, T, fa, kw, get_config,
                          smi.splitlines()[0], wkv_ptxas)
    walls.append(time.perf_counter())
    tp_rs_counts = {k: sum(r.get(k, 0) for r in tp_rs) for k in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "wkv")}
    print(json.dumps({"phase_wall_s": {
        n: b - a for n, a, b in zip(
            ("21", "22", "23", "24a-b",
             "the ranks of 24c, 25c's 1x1x2 and 2x1x1, 27d and 28", "24c",
             "24d", "25a", "25b", "25c one rank", "25d", "26a", "26b",
             "26c", "26d", "26e", "26f one rank", "27a", "27b", "27c",
             "27d", "28 in this process", "29 in this process", "30",
             "31 in this process", "32 in this process",
             "33 in this process", "34"),
            walls, walls[1:])},
        "pool4_ranks_wall_s": {k: max(r["wall_s"][k] for r in pool4)
                               for k in pool4[0]["wall_s"]}}), flush=True)

    main_fwd = recs[MAIN_SHAPE]
    main_bwd = bwd[TRAIN_SHAPE]
    sources = {
        "flash_fwd": ("src/repro_torch/kernels/csrc/flash_fwd.cu",
                      "src/repro/kernels/flash_attention.py:68", main_fwd,
                      serve_counts["flash_fwd"] + train_counts["flash_fwd"]
                      + grid_counts["flash_fwd"] + net_counts["flash_fwd"]
                      + bucket_counts["flash_fwd"]
                      + elastic_counts["flash_fwd"]
                      + moe_counts["flash_fwd"] + dense_flash + tp_flash
                      + tp_train_counts["flash_fwd"]
                      + family_counts["flash_fwd"]
                      + tp_counts["flash_fwd"] + tp_rs_counts["flash_fwd"]
                      + tp_elastic_counts["flash_fwd"]
                      + inside["flash_fwd"] + width_counts["flash_fwd"]),
        "flash_bwd_dq": ("src/repro_torch/kernels/csrc/flash_bwd.cu",
                         "src/repro/kernels/flash_attention.py:186",
                         main_bwd["flash_bwd_dq"],
                         train_counts["flash_bwd_dq"]
                         + grid_counts["flash_bwd_dq"]
                         + bucket_counts["flash_bwd_dq"]
                         + elastic_counts["flash_bwd_dq"]
                         + tp_train_counts["flash_bwd_dq"]
                         + family_counts["flash_bwd_dq"]
                         + tp_counts["flash_bwd_dq"]
                         + tp_rs_counts["flash_bwd_dq"]
                         + tp_elastic_counts["flash_bwd_dq"]
                         + inside["flash_bwd_dq"]
                         + width_counts["flash_bwd_dq"]),
        "flash_bwd_dkv": ("src/repro_torch/kernels/csrc/flash_bwd.cu",
                          "src/repro/kernels/flash_attention.py:224",
                          main_bwd["flash_bwd_dkv"],
                          train_counts["flash_bwd_dkv"]
                          + grid_counts["flash_bwd_dkv"]
                          + bucket_counts["flash_bwd_dkv"]
                          + elastic_counts["flash_bwd_dkv"]
                          + tp_train_counts["flash_bwd_dkv"]
                          + family_counts["flash_bwd_dkv"]
                          + tp_counts["flash_bwd_dkv"]
                          + tp_rs_counts["flash_bwd_dkv"]
                          + tp_elastic_counts["flash_bwd_dkv"]
                          + inside["flash_bwd_dkv"]
                          + width_counts["flash_bwd_dkv"]),
        # quantise without EF runs in the collectives phase; the grid's
        # training (phases 11, 20, 25b and 30) runs the fused EF kernel and
        # the dequant; the tree phase's compressed syncs run all three
        "quantize_int8": ("src/repro_torch/kernels/csrc/quant.cu",
                          "src/repro/kernels/quant.py:30",
                          quant["quantize_int8"],
                          coll["launches"]["quantize_int8"]
                          + tree["launches"]["quantize_int8"]),
        "dequantize_int8": ("src/repro_torch/kernels/csrc/quant.cu",
                            "src/repro/kernels/quant.py:39",
                            quant["dequantize_int8"],
                            grid_counts["dequantize_int8"]
                            + tree["launches"]["dequantize_int8"]
                            + elastic_counts["dequantize_int8"]
                            + tp_train_counts["dequantize_int8"]
                            + family_counts["dequantize_int8"]
                            + tp_elastic_counts["dequantize_int8"]),
        "quantize_ef_int8": ("src/repro_torch/kernels/csrc/quant.cu",
                             "src/repro/kernels/quant.py:44",
                             quant["quantize_ef_int8"],
                             grid_counts["quantize_ef_int8"]
                             + tree["launches"]["quantize_ef_int8"]
                             + elastic_counts["quantize_ef_int8"]
                             + tp_train_counts["quantize_ef_int8"]
                             + family_counts["quantize_ef_int8"]
                             + tp_elastic_counts["quantize_ef_int8"]),
        "wkv": ("src/repro_torch/kernels/csrc/wkv.cu",
                "src/repro/kernels/wkv.py:32", wkv_recs[WKV_MAIN],
                rwkv_counts["wkv"] + rwkv_train["wkv"]
                + rwkv_answer_counts["wkv"] + tp_rs_counts["wkv"]
                + wide_wkv),
    }
    for name, (_, _, _, n) in sources.items():
        if n < 1:
            fail(f"{name} was not launched on its path")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": n, "max_abs_err": rec["max_abs_err"],
        "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"]}
        for name, (src, rep, rec, n) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
