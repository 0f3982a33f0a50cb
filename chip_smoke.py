#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port builds, runs and is right there.

    python3 chip_smoke.py [--out DIR] [--profile] [--turns N]

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, all started together);
  3. kernels: each of the four fused-BN kernels against its plain
     PyTorch version on the card (``bn_apply`` and ``bn_bwd_dx``
     bitwise, ``bn_bwd_dx`` also with non-zero mean / var cotangents, in
     given-stats mode and with a two-worker cross-replica site's count of
     2 x rows, ``bn_stats`` the same bits on a second launch),
     at every BN-site shape of ResNet-50
     at batch 32 (stem 401,408 x 64 down to stage 3 1,568 x 2,048), in
     bf16 and f32, with kernel, plain and library times (CUDA events)
     and the HBM-bytes bound of each shape; the library yardsticks are
     ``torch.var_mean`` and ``torch.batch_norm_stats`` for ``bn_stats``,
     ``F.batch_norm`` (eval) for ``bn_apply``, the site pair against
     ``aten::native_batch_norm`` and its backward (also with
     ``threshold_backward`` in front at the ReLU sites), and at the
     sites with neither ReLU nor residual ``bn_bwd_sums`` / ``bn_bwd_dx``
     against ``torch.batch_norm_backward_reduce`` / ``_elemt`` (given
     the same sums); and whether ATen's division of a CUDA tensor by a
     Python float is a true division (logged);
  3b. the fused update, the wire cast and the fused input kernels against
     their plain versions, bitwise: ``hybrid_update`` for one leaf at
     every distinct ResNet-50 leaf size and the whole 25.56 M-element
     stream (decay none, scalar and a stream; a_sgd 0, 0.5 and 1), and
     over all 161 leaves and a one-element leaf in one launch (decay
     none and per leaf, gradients as views 0, 1 and 2 elements into one
     stream), ``cast_copy`` to bf16/f16 and back at the whole stream,
     odd lengths (7, 8k + 3) and views 4 and 8 bytes (f32) or 2 and 4
     bytes (half) into a buffer, the sync's one-pass ends over the
     161 leaves and 64 MiB buckets (``pack_leaves`` and
     ``unpack_buckets`` bitwise the sequence they replace at n = 1 and
     3, the norm within rtol 1e-5 of a float64 sum and the same bits
     twice, timed beside that sequence), ``input_train``/``input_eval`` at (32,
     224, 224, 3) with +-4 shifts and flips, bf16 and f32 out, and
     ``input_train`` at edge shapes ((2, 7, 5, 3), C = 1 and 4, an
     unaligned input) with shifts of +-W, +-(W+1) and +-3H; with kernel,
     plain, library and bound times per main-path step (the update also
     as one launch per leaf, the earlier design), and the host time of
     ``optimizer.update`` at main path 2's shapes against that of one
     launch per leaf;
  3c. the stream-LARS kernels against their plain versions:
     ``seg_sq_partials`` within rtol 1e-5 of a float64 sum of the same
     inputs and the same bits on a second launch, ``lars_update``
     bitwise, at ResNet-50's whole stream (162 segments), at the
     worker slices of an ``align=4`` plan for 2 and 4 workers, with zero
     gradients, and at edge cases (1 element, an empty segment,
     1-element segments, a segment across the kernels' chunks, a length
     not a multiple of 128); with kernel, plain and bound times, and
     ``hybrid_update`` timed with the per-element decay stream;
  3d. ``flash_attention`` and ``rmsnorm`` against their plain versions,
     bf16 and f32: flash at the serving path's prefill (8 x 1,024
     tokens, 32 query heads on 8 kv heads, Dh 64, causal), lengths 1 and
     1000, Sq != Sk, non-causal, a causal window of 256, groups 1, 4 and
     8, Dh 32, 96, 112 and 128, the 64-row tile edges (f32 rtol 1e-5 /
     atol 1e-6, bf16 within one bf16 ulp beyond that), and bf16 q, k, v
     that are views 8 bytes into their buffers, bitwise equal to their
     aligned copies' result; rmsnorm in both rounding orders (the Pallas
     kernel's and the JAX model's, which the serving path runs) at
     8,192 x 2,048 and 8 x 2,048 (a prefill's and a decode step's norm
     sites), odd row counts and d = 128 and 100 (f32 rtol 1e-6, bf16
     within two bf16 ulps: it rounds twice); with kernel, plain and
     library times (``F.scaled_dot_product_attention``, ``F.rms_norm``,
     every rmsnorm call given the same bf16 scale as the serving path's
     parameters are; ``F.rms_norm`` also logged at the decode site) and
     the bound of each case, each rmsnorm case with its share of the
     bound and, at decode rows, the empty kernel on its own grid as its
     least time; an empty kernel timed the same way (the launch floor)
     at rmsnorm's decode grid; rmsnorm's row sum order set by d and the
     dtype alone: at each RMSNorm width of the registry, in bf16 and
     f32, a row of the prefill batch gets the same bits normalized in
     the batch, among 8 rows, alone, and (through the generic instance)
     as a view 2 elements into its buffer;
  3e. gradients through the LM kernels' autograd Functions: rmsnorm in
     both orders and dtypes, flash at Dh 64 and 96 in both dtypes; every
     gradient (x and scale; q, k and v) present, finite, not all zero,
     and bitwise equal to the plain version's own autograd;
  4. main path 1 (slice 1, one device):
     ``repro_torch.launch.train.build_train_setup`` for the full-width
     ResNet-50 (stages 3,4,6,3, width 64, 1000 classes, 224
     px), global batch 32, bf16, fused BN, rmsprop_warmup + slow_start,
     bf16 wire cast, driven by the ``Trainer`` for one epoch of 8
     steps and one eval batch; launch counts must be 53 per
     train step (and 53 more per eval batch for bn_apply), and one more
     step under torch.profiler must run two ``bn_bwd_sums`` kernels and
     one ``bn_bwd_dx`` kernel per BN site (the same in 6 and 8);
  5. reference: the reduced ResNet in f32 on the card, fused kernels vs
     the unfused plain path, three steps from the same seed;
  6. main path 2, the paper's data-parallel step at world size 1 (NCCL):
     the same model and recipe with ``dp_mode="shardmap"``, the bucketed
     bf16 all-reduce, the fused update (one launch a step over every
     leaf), the fused input and a 4-worker feed, 8 steps and one eval
     batch after the BN all-reduce; every kernel's launch count is
     checked, and the wire cast's by entry (one ``pack_leaves`` and one
     ``unpack_buckets`` a step; on the overlapped sync one ``cast_copy``
     a segment in place of the pack);
  6b. reference: the reduced ResNet in f32, the DP step with every new
     kernel on against the same step with them off (plain per-leaf
     update, per-leaf all-reduce, host input transform), three steps;
  8. main path 3, stream-LARS on the DP step at world size 1 (NCCL):
     main path 2 with the ``lars_ls_poly`` recipe (LARS, poly schedule,
     label smoothing 0.1); the update runs on the packed stream through
     ``seg_sq_partials`` and ``lars_update``, once each per step, and
     ``hybrid_update`` never; every launch count is checked;
  8b. reference: the reduced ResNet in f32, the stream-LARS DP step with
     error feedback, twice with the kernels on (bitwise equal) and once
     with the plain stream update (losses within rtol 1e-5, parameters
     within a relative norm of 1e-5), three steps.
  9. main path 4, serving: ``repro_torch.launch.serve.serve`` of
     llama3.2-1b at full width (16 layers, d 2,048, 128,256-token
     vocabulary), 8 prompts of 1,024 tokens, one prefill and 31 greedy
     decode steps, bf16, chunked (flash) attention; the launch counts
     are checked (flash 16 per prefill and none per decode step, rmsnorm
     33 per forward), the first call against a warm one, peak device
     memory, and the prefill logits against the same prompts through
     the naive attention (relative norm within 5e-2);
  9b. reference: the reduced llama3.2-1b in f32 with the same weights on
     the card (kernels) and on the CPU (plain versions), prefill and 6
     decode steps, logits within rtol/atol 1e-4 and the same tokens.
  10. main path 2 with checkpoints, cuDNN deterministic: 6 steps with a
     save every 3 and one eval batch (the best checkpoint), then a fresh
     ``Trainer`` resumes from the step-3 checkpoint alone and runs to 6:
     params, ``delta``, ``m``, BN state and ``opt.step`` bitwise equal to
     the unbroken run; also 6 steps without checkpoints (every run's
     launch counts checked); the checkpoint's bytes, the ms the loop's
     thread blocks for the snapshot, the background write's ms, the
     restore's ms, and the step time with saves against without;
  10b. the sentinel on main path 2 (``sentinel=True``) with chaos
     ``nan_grad@4,ckpt_truncate@6,nan_grad@7-8`` and a save every 3:
     step 4 skipped with the state after it bitwise the state after
     step 3, steps 7 and 8 skipped and rolled back past the torn step-6
     checkpoint to step 3 (``corrupt_checkpoint_skipped``), the run
     completes, the event log on disk equals the one in memory, every
     call's launches counted; then 6 steps with the sentinel on and no
     fault (its cost beside phase 10's run without it) and the device
     time of its copy of the in-place state.
  11. main path 5, cross-replica BN: main path 2 with ``sync_bn=True``
     beside main path 2 itself, both cuDNN deterministic; the launch
     counts equal, the state after the steps bitwise equal (at world
     size 1 every all-reduce is a sum of one), and one more step of each
     counting ``dist.all_reduce`` calls: 3 more a BN site (159), with the
     profiler's all-reduce ops and NCCL kernels logged beside; the step
     times side by side;
  11b. the cross-worker sums on the card: two processes share the card
     over gloo (a ``file://`` store), the reduced ResNet in f32 with
     fused BN and ``sync_bn=True``, three steps, against the same two
     workers on the CPU: losses within rtol 2e-5, parameters within a
     relative norm of 2e-4 (``bn_bwd_dx`` with the count 2 x rows);
  12. main path 6, the overlapped sync: main path 2 with
     ``overlap_comm=True`` (16 MiB buckets) bitwise equal to phase 11's
     main path 2, then main path 3 with and without it, bitwise equal
     (losses, parameters, ``delta``, BN state); ``cast_copy`` launched
     once a segment and once for the unpack; whether the first bucket is
     launched (host) and its NCCL kernel starts (device) before the last
     BN backward, logged; the step times side by side;
  12b. reference: the reduced ResNet in f32, the overlapped step with
     error feedback and every kernel on against the per-leaf step with
     them off, three steps, bitwise (losses, parameters, residual); and
     stream-LARS with error feedback, overlapped against bucketed,
     bitwise (losses, parameters, ``delta``, residual).
  13. main path 7, ZeRO: two processes share the card over gloo, each
     with 32 images (64 in all) of full-width ResNet-50, bf16, fused BN,
     update and input, ``bf16+bucketed`` (64 MiB), rmsprop_warmup +
     slow_start and ``zero_dp=True``: 8 steps and one eval batch through
     the ``Trainer``, then main path 2's configuration at 2 workers from
     the same seed, bitwise (losses, parameters, BN state, ``opt.step``,
     and ``delta`` / ``m``, the per-leaf state packed into the stream and
     cut to the worker's shard); launches a step as main path 2's, with
     ``hybrid_update`` through its decay-stream entry; one more step
     counting one reduce-scatter and one all-gather a bucket and one
     all-reduce (the metrics); a save every 2 of 4 steps, resumed from
     step 2 alone, and the step-2 checkpoint restored into main path 2's
     per-leaf state (``make_zero_restore_transform``), both bitwise the
     unbroken run; the step times (gloo on one card: not a user's
     figure), peak memory and optimizer-state bytes a worker; then
     ``hybrid_update`` at the worker's shard (12,778,516 elements, decay
     stream), bitwise and timed against its bound;
  13b. in the same two processes, the reduced ResNet in f32 with every
     kernel on: ZeRO + overlap (16 KiB buckets, error feedback) against
     overlap, ZeRO stream-LARS and ZeRO ``momentum_sgd`` against their
     bucketed steps (bitwise), and ZeRO + overlap stream-LARS against
     overlapped stream-LARS within rtol 1e-2 / atol 1e-4 (a ZeRO worker
     sums its trust norms over its ready-order shard).
  14. main path 8, the hierarchical schedule: four processes share the
     card over gloo as a 2x2 layout (``--mesh 2x2 --comm-plan hier:1``:
     a reduce-scatter inside each pair, an all-reduce of the half shard
     across the pairs, an all-gather inside the pair), each with 32
     images (128 in all) of full-width ResNet-50, bf16, fused BN, update
     and input, ``bf16+bucketed`` (64 MiB), rmsprop_warmup + slow_start:
     (A) bucketed + hier, (B) ZeRO + hier (the double scatter and the
     two-level all-gather) and (C) the flat bucketed step at 4 workers,
     8 steps and one eval batch each through the ``Trainer`` from one
     seed: B bitwise A (parameters, BN state, ``opt.step``, ``delta`` /
     ``m`` as the worker's shard; the losses within 2.4e-7, ZeRO's
     metrics carrying one more entry through gloo's ring); C's first
     loss bitwise A's and its loss after the first update within rtol
     1e-3 (the flat sum rounds after each add; the tolerance of
     ``tests/test_torch_hierarchical.py``), the later losses and the
     parameters' relative differences logged; one more step of A and of B
     counting the collectives per group (A: per bucket one inner
     reduce-scatter, one outer all-reduce, one inner all-gather; B: two
     reduce-scatters and two all-gathers; each one all-reduce of the
     metrics); launches a step as main path 2's (A, C) and main path 7's
     (B); the step times (gloo on one card: not a user's figure) and
     peak memory a worker; the primitives on CUDA tensors (4 M elements
     a worker, bf16 and f16): the hierarchical all-reduce and
     reduce-scatter bitwise the flat ones on exact data, the all-gather
     bitwise on normal data, the all-reduce's chunk bitwise the double
     scatter's;
  14b. in the same four processes, the reduced ResNet in f32 with every
     kernel on, each under hier:1: overlap against bucketed, plain and
     with error feedback, ZeRO + overlap against overlap, ZeRO
     stream-LARS and ZeRO ``momentum_sgd`` against their bucketed steps
     (the state bitwise; ZeRO's losses within 2.4e-7), and ZeRO +
     overlap stream-LARS against overlapped stream-LARS within rtol 1e-2
     / atol 1e-4.
  3f. the four kernels of main paths 9 and 10 at their shapes, bf16:
     ``flash_attention`` at yi-9b's, granite-34b's and qwen2-72b's
     prefills (8 x 1,024 tokens, Dh 128, 32 / 4, 48 / 1 and 64 / 8
     heads) and llama3.2-1b's training batch (4 x 1,024, 32 / 8, Dh 64),
     ``rmsnorm`` at yi-9b's and qwen2-72b's prefill and decode rows (d
     4,096 and 8,192) and the training batch's (4,096 x 2,048), each
     against its plain version (the tolerances of 3d) and timed with
     SDPA / ``F.rms_norm`` and its bound; ``hybrid_update`` over
     llama3.2-1b's 11 f32 leaves (1,235,814,400 elements) in one launch,
     bitwise per leaf, timed with its plain version and bound;
     ``cast_copy`` and the one-pass ends at that gradient stream (as
     3b's ``cast_phase``);
  15. main path 9, the other dense configs served
     (``repro_torch.launch.serve.serve``, weights drawn on the card):
     yi-9b at full width and depth (48 layers, d 4,096, 32 / 4 heads, Dh
     128, vocabulary 64,000) with 8 prompts of 1,024 tokens and 31
     greedy decode steps, granite-34b (LayerNorm, GELU, one kv head) and
     qwen2-72b (qkv bias) at full width with their depth cut to 8 and 4
     layers, one prefill and 3 decode steps each, bf16, chunked (flash)
     attention: launches per prefill and decode step checked (flash one
     a layer per prefill, rmsnorm 2 a layer + 1 per forward, none for
     granite), the warm call, peak memory, prefill logits against the
     naive attention's within ``NAIVE_REL_TOL``;
  16. main path 10, LM training: llama3.2-1b at full width (16 layers,
     d 2,048, vocabulary 128,256, tied), batch 4 x 1,024 tokens, bf16,
     flash attention (its gradient the plain version's, recomputed),
     rmsprop_warmup + slow_start through the fused update, 6 steps and
     one eval batch through the ``Trainer`` on one device (the bf16
     wire cast), then through the DP step at world size 1 over NCCL
     (``bf16+bucketed``), bitwise the one-device run (losses,
     parameters, ``delta``, ``m``, ``opt.step``; deterministic
     algorithms on); launches a step checked (flash 16 and rmsnorm 33 a
     forward, none in the backward; ``hybrid_update`` 1; ``cast_copy``
     2 on the DP step, none on one device), step time, tokens/s, peak
     memory;
  16b. reference: the reduced llama3.2-1b in f32, 3 train steps on the
     card against the CPU from the same weights (losses within rtol
     2e-5, parameters within a relative norm of 2e-4).
  3f (slice 14, after 3f). ``flash_attention`` in bf16 and f32 at
     mixtral-8x7b's windowed prefill (1 x 5,120 tokens, 32 / 8 heads,
     Dh 128, window 4,096: keys past the window) and llama4-maverick's
     (8 x 1,024, 40 / 8 heads: a GQA group of 5), ``rmsnorm`` at their
     prefill and decode rows (d 4,096 and 5,120), each against its plain
     version and timed with SDPA (the window as a boolean mask) /
     ``F.rms_norm`` and its bound; ``flash_attention`` in bf16 and
     ``rmsnorm`` at main paths 12 and 13's own mixtral shapes too (the
     prefills of 8 x 1,024 and of 4,064 tokens, whose 64-row tiles end
     in a tail, and the training forward of 4 x 1,024);
     ``hybrid_update`` and ``cast_copy`` at main path 13's leaves
     (mixtral-8x7b at 1 layer, 1,713,418,240 elements), as for path 10;
  17. main path 11, the LM on the other DP steps: main path 10's DP step
     with ``overlap_comm=True`` (its staged loss: embed, 4 layer
     segments, head) at world size 1 over NCCL, full depth, 6 steps and
     one eval batch, bitwise main path 10 (losses, parameters,
     ``delta``, ``m``, ``opt.step``), 7 ``cast_copy`` a step; then
     four processes sharing the card over gloo, spawned once,
     llama3.2-1b at full width, 4 x 1,024 tokens a worker, bf16, flash,
     one step: the four as a 2x2 layout under ``hier:1`` (2 of 16
     layers) ZeRO + hier against bucketed + hier, then two of them (4
     layers) ZeRO against the bucketed step, each bitwise (losses,
     parameters, ``opt.step``, the optimizer state as the worker's
     shard), launches a step checked;
  17b. in the same processes, the reduced llama3.2-1b in f32: overlap,
     ZeRO and ZeRO + overlap against bucketed (under ``hier:1`` at 4),
     bitwise; in this process the staged loss of the reduced
     llama3.2-1b and llama4-maverick in f32 against ``loss_fn``'s
     gradients, bitwise (the tied table within 2.4e-7);
  18. main path 12, the MoE family served (``serve()``, weights drawn
     on the card leaf by leaf), 8 prompts, bf16, flash: mixtral-8x7b at
     full width, 8 of its 32 layers, 1,024-token prompts and 31 decode
     steps; llama4-maverick at one layer group of its 24 (a dense and a
     MoE layer with 128 experts and the shared expert), 3 decode steps;
     mixtral again with 4,064-token prompts and 64 decode steps, which
     wrap the 4,096-slot ring during decode; launches per prefill and
     decode step checked, the warm call, peak memory, prefill logits
     against the naive attention's within ``NAIVE_REL_TOL`` with the
     naive prefill's expert routing replayed (``RouteTape``: a token
     near a tie between two experts may route otherwise under either
     attention), the free reading and the tokens routed otherwise
     logged (not for the long prompts: 17 GB of naive scores);
  18b. reference: the reduced mixtral-8x7b and llama4-maverick in f32,
     card against CPU, prefill (4 x 128 tokens) and 6 decode steps,
     logits within 1e-4, the same tokens;
  19. main path 13, MoE training: mixtral-8x7b at full width, 1 of 32
     layers (1,713,418,240 parameters), main path 10's batch and recipe,
     3 steps and one eval batch on one device, then the DP step at world
     size 1 over NCCL, bitwise (deterministic algorithms on; the
     one-device state waits on the card: ``family_train_path``, as main
     path 15).
  3g (after 3f). ``flash_attention`` in bf16 and f32 at main path 14's
     prefills: phi-3-vision (8 x 1,600 rows: 576 patches + 1,024 tokens,
     32 / 32 heads, Dh 96, causal), zamba2-7b's shared attention (8 x
     1,024, 32 / 32, Dh 112, window 4,096), whisper-tiny's encoder (8 x
     1,500 x 1,500, non-causal: 1,500 keys end in a partial 64-row
     tile), decoder (8 x 1,024, causal) and cross attention (1,024 x
     1,500, non-causal), 6 / 6 heads, Dh 64; in bf16 at main path 15's
     training shapes (batch 4); ``rmsnorm`` at main path 14's prefill
     and decode rows at d 3,072, 3,584, 7,168 and 2,048; each against
     its plain version (the tolerances of 3d) and timed with SDPA (a
     boolean mask for the window) / ``F.rms_norm`` and its bound;
  20. main path 14, the last four families served whole at full width
     (``serve()``, weights drawn on the card leaf by leaf), 8 prompts of
     1,024 tokens, 31 greedy decode steps, bf16, flash: phi-3-vision
     (32 layers, 576 patches of 1,024 ahead of each prompt), zamba2-7b
     (81 Mamba2 layers, 13 shared-attention applications, its 4,096-slot
     serving window), xlstm-350m (21 mLSTM and 3 sLSTM layers) and
     whisper-tiny (4 + 4 layers, 1,500 frames); launches per prefill and
     decode step checked (``lm_launches``), the warm call, peak memory,
     prefill logits against the naive attention's within
     ``NAIVE_REL_TOL`` (not xLSTM: no attention), and one prefill and 4
     decode steps under torch.profiler (device busy time, idle share,
     kernels a call);
  20b. reference: the reduced four in f32, card against CPU, prefill (4
     x 128 tokens, with patches or frames) and 6 decode steps, logits
     within 1e-4, the same tokens;
  21. main path 15, the last four families trained at full width, main
     path 10's batch and recipe, 3 steps and one eval batch on one
     device, then the DP step at world size 1 over NCCL, bitwise (the
     one-device state waits on the card, zamba2's on the host): phi-3-vision at 4 of 32 layers
     (also overlapped, bitwise the bucketed DP step), zamba2-7b at 12 of
     81 layers (two groups: both shared blocks), xlstm-350m at 8 of 24
     (one segment: 7 mLSTM and 1 sLSTM layers), whisper-tiny whole;
     launches a step checked.
  3h (after 3g). ``flash_attention`` (bf16) at main path 17's
     worker-local heads (16 / 4, Dh 64, 4 x 1,024), ``rmsnorm`` at its
     rows and ``hybrid_update`` over one TP worker's shards of every
     leaf in one launch, against their plain versions (the update
     bitwise) and timed;
  16c (after 16b). main path 10 on one device with remat (every LM of
     more than 8 layers checkpoints each layer group in training, as the
     JAX launcher does; paths 10, 11 and zamba2's on 15 count the
     recomputed sites) and without, 2 steps and one eval batch each:
     losses and state bitwise, step times and peak memory;
  22. main path 16, ResNet-50 at full width under ``--dp-mode gspmd
     --mesh 2x1 --fused-bn --use-fused-kernel``: two processes share the
     card over gloo, 32 images a worker, bf16, 3 steps, BN over the
     global batch, the BN and update kernels' launches checked; its
     state and losses bitwise main path 5's step at the same workers;
     its first update in f32 (f32 wire, momentum SGD) against one
     process on the 64-image batch (``GSPMD_*`` tolerances); two more
     steps under torch.profiler (idle share);
  23. main path 17, llama3.2-1b at full size under ``--dp-mode gspmd
     --mesh 1x2`` (Megatron TP 2, remat on), two processes on the card
     over gloo, main path 10's batch and recipe, 3 steps: flash on each
     worker's heads, rmsnorm, the fused update on its shards, launches
     checked; the first loss against main path 10's within
     ``GSPMD_TP_LOSS_RTOL``; step time and peak memory a worker.
  3i (after 3h). ``flash_attention`` (bf16) at main paths 18 and 19's
     worker-local heads and ``rmsnorm`` at their rows (whole under TP,
     the out_norm sites of zamba2 and xLSTM too), against their plain
     versions and timed (``SLICE18_*``; rmsnorm also with L2 emptied
     before each call), and ``hybrid_update`` over one worker's shards
     of each config the two paths train, bitwise per leaf;
  24. main path 18, MoE under ``--dp-mode gspmd --mesh 1x2`` (EP 2),
     one spawn of two processes on the card over gloo, bf16: mixtral at
     main path 13's cut (1 of 32 layers), 2 steps, the first one's
     routing replayed from a one-device step at the same weights and
     batch (``RouteTape``; the token choices that differ counted), its
     first loss within ``GSPMD_FAMILY_LOSS_RTOL``; then the GSPMD
     prefill of main path 12's requests and 4 greedy decode steps
     (``build_gspmd_serve_setup``, the cache placed by ``place_cache``)
     for mixtral at 4 of 32 layers and llama4-maverick at one group (64
     of 128 experts a worker), the routing of every call replayed from
     the one-device run and each decode step fed the one-device run's
     greedy token (teacher forcing): the prefill's and each decode
     step's logits within ``GSPMD_MOE_SERVE_TOL``, each greedy choice
     the one-device run's
     but at a tie of its two candidates (``GSPMD_TIE_GAP``; the choices
     that differ logged); launches a worker a step, a prefill and a
     decode step checked;
  25. main path 19, phi-3-vision, zamba2-7b, xlstm-350m and
     whisper-tiny under ``--mesh 1x2`` (TP 2) at main path 15's depths
     (zamba2 served at 6 of its 12), one spawn as 24: 2 steps (first
     loss within
     ``GSPMD_FAMILY_LOSS_RTOL`` of main path 15's), the GSPMD prefill
     of main path 14's requests and 4 teacher-forced decode steps
     against the one-device run (each call's logits within the family's
     ``GSPMD_FAMILY_SERVE_TOL``, the greedy choices as 24), the same
     prefill in f32 against one device's in f32 within
     ``GSPMD_F32_SERVE_TOL`` (the witness that the bf16 distance is
     rounding), launches checked.
  3j (after 3i). ``flash_attention`` (bf16) at main path 21's prefill
     (granite-34b's 4,096 tokens whole, its 48 heads and a worker's 24
     on one kv head) and main path 20's worker-local heads, ``rmsnorm``
     at main path 20's rows (a worker's 2,048 of yi-9b's width), against
     their plain versions and timed, and ``hybrid_update`` over one
     worker's FSDP x TP x ZeRO-1 shards of main path 20's leaves,
     bitwise per leaf;
  26. main path 20, yi-9b at full width, 1 of 48 layers, under its own
     policy (``cell_parallel``: FSDP's "embed" over "data", Megatron TP
     over "model", ZeRO-1, the bf16 wire, per-layer remat), ``--mesh
     2x2``: four processes on the card over gloo, main path 10's batch
     and recipe, 2 steps: the first loss within ``FSDP_LOSS_RTOL`` of
     one device's on the same weights and batch, each worker's
     parameters a quarter of every leaf split over both axes, its peak
     memory in the steps below the same run's without ``fsdp_params``;
     in the same processes, in f32, one step with and one without
     ``fsdp_params`` against one device's (the parameters within
     ``HYBRID_F32_TOL``), ``microbatches=2`` against
     one (the loss within ``ACCUM_LOSS_RTOL``, the parameters within
     ``ACCUM_LEAF_TOL``, one device's own microbatches as the control)
     and one LARS step against one device's (trust ratios within
     ``LARS_TRUST_RTOL``, parameters within ``LARS_PARAM_TOL``), each
     parameter bound below the smallest step a leaf takes; launches
     checked, DTensor's own all-gather, reduce-scatter and all-to-all
     counted at 0;
  27. main path 21, granite-34b at full width, 8 of 88 layers, served
     under its batch-1 prefill policy (TP over "model", sequence
     parallelism, the cache's positions on "model"), ``--mesh 1x2``:
     two processes on the card, one 4,096-token prompt, a bf16 prefill
     and 4 decode steps teacher-forced by one device's tokens: each
     worker's cache holds half the positions, the logits within
     ``SP_SERVE_TOL`` of one device's (its own bf16-vs-f32 distance
     rounded up), the greedy choices as 24, the same prefill in f32
     within ``SP_F32_TOL`` of one device's f32 prefill and the bf16
     prefill within ``SP_F32_RATIO`` of one device's bf16 distance from
     that f32 prefill; launches checked, DTensor's own collectives
     counted at 0;
  28. the audit of the recorded step (``analysis/audit.py``): eight
     processes on the card over gloo run every sync mode x {sgd, lars}
     (flat 8 x 1, hierarchical 2 x 4 with ``hier_split=1``), f32, the
     f16 wire, global batch 16, each cell's second step recorded (a
     gspmd or perleaf cell's first, its steady one): at
     full ResNet-50 every cell meets the JAX package's contract
     (``analysis/contracts.py``) on every worker but the one check the
     JAX package's own full audit fails in its four stream-LARS ZeRO
     cells (held to exactly that), both ZeRO relations hold, each recorded backward holds 53 ``convolution_backward`` ops;
     at the reduced config the bucketed, overlapped, ZeRO and
     hierarchical cells' qualifying collective counts and
     ``gradient_sync`` equal ``AUDIT.json``'s and so do the ZeRO
     relations' expected shrinks (gspmd's and perleaf's counts printed);
     ``cast_copy`` launched in every bucketed cell, ``seg_sq_partials``
     and ``lars_update`` in every stream-LARS cell; then those kernels
     timed at the full cells' shapes (the stream and a worker's shard)
     with their plain versions, bounds and library calls; and the
     fusion report of one BN site recorded fused against unfused
     (fewer reduction passes, no more activation writes).
With ``--profile``, a few more steps of each main path run under
torch.profiler (device busy time and idle share, top host ops and
kernels), and one prefill and four decode steps of main path 4. With
``--turns N``, phase 7 runs the main paths again in turns, N times: main
paths 2, 5 and 6, main path 2 fed pre-made batches (its producer threads
then only hand them over), main path 1 twice, then the others in
reverse, for their wall step times side by side. Then a ``{"kernels":
[...]}`` line (launches from main path 2 for its eight kernels, from
main path 3 for the two stream-LARS kernels, from main path 4 for
flash_attention and rmsnorm, whose times are per prefill;
``launches_by_path`` holds every main path's, main paths 7's and 8's
from their first worker, ``path8`` run A and ``path8_zero`` run B,
``path9_<arch>`` main path 9's per config, ``path10`` and ``path10_dp``
main path 10's one-device and DP runs, ``path11`` the overlapped LM
step and ``path11_<n>w_<run>`` its multi-process runs (first worker),
``path12_<arch>_p<prompt>`` main path 12's per run, ``path13`` and
``path13_dp`` main path 13's, ``path14_<arch>`` main path 14's per
config, ``path15_<arch>_<run>`` main path 15's per config and run,
``path10_remat`` / ``path10_no_remat`` phase 16c's, ``path16`` to
``path21`` main paths 16 to 21's (first worker; 18 and 19 summed over
their runs, 20 its first run's, 21 its prefill's and first decode
step's), ``audit`` phase 28's summed over the full cells' recorded
steps (rank 0); ``slice13``, ``slice14``, ``slice15``, ``slice17``,
``slice18`` and ``slice19`` the times of phases 3f, 3g, 3h, 3i and 3j
at those paths' shapes, ``audit`` phase 28's;
``hybrid_update`` also carries its time at main path 7's shard), the card's name and power
limit, and last the ``{"ok": true, "device": ...}`` line. ``--out DIR`` also
writes the per-shape kernel tables to ``DIR/chip_smoke_kernels.json``.

It exits non-zero before printing any result when no CUDA device is
present or when the port's sources are not beside it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores, same sheet
BF16_FLOPS_PER_S = 989e12  # bf16 dense on the tensor cores, same sheet
BATCH = 32  # the paper's per-GPU minibatch (32,768 over 1,024 GPUs)
STEPS = 8  # main-path train steps: the first is set-up, 7 are timed
# main path 4: llama3.2-1b serving 8 prompts of 1,024 tokens, then 31
# greedy decode steps (the first of the 32 tokens comes from the prefill)
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 8, 1024, 32
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = CSRC + "fused_bn.cu"
REPLACES = {"bn_stats": "src/repro/kernels/fused_bn.py:54",
            "bn_apply": "src/repro/kernels/fused_bn.py:90",
            "bn_bwd_sums": "src/repro/kernels/fused_bn.py:108",
            "bn_bwd_dx": "src/repro/kernels/fused_bn.py:132"}
KERNELS = tuple(REPLACES)
# the kernels of main path 2 beyond fused BN: source, the Pallas body
# each replaces (the variants ride on the same kernel: _kernel_wd through
# hybrid_update's wd pointer)
NEW_KERNELS = {
    "hybrid_update": ("fused_update.cu",
                      "src/repro/kernels/fused_update.py:24"),
    "cast_copy": ("bucket_ops.cu", "src/repro/kernels/bucket_ops.py:30"),
    "input_train": ("fused_input.cu", "src/repro/kernels/fused_input.py:41"),
    "input_eval": ("fused_input.cu", "src/repro/kernels/fused_input.py:50"),
}
# the kernels of main path 3 beyond those of main path 2
LARS_KERNELS = {
    "seg_sq_partials": ("fused_update.cu",
                        "src/repro/kernels/fused_update.py:130"),
    "lars_update": ("fused_update.cu",
                    "src/repro/kernels/fused_update.py:189"),
}
# the kernels of main path 4 (serving llama3.2-1b)
LM_KERNELS = {
    "flash_attention": ("flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:29"),
    "rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:20"),
}
SOURCES = ("fused_bn", "fused_update", "bucket_ops", "fused_input",
           "flash_attention", "rmsnorm", "launch_floor")
# flops per element of the hybrid update (decay 2, m 4, coef 4, delta 3,
# theta 2) and of the input transform (subtract, multiply)
UPDATE_FLOPS, INPUT_FLOPS = 15, 2
# per element: seg_sq_partials g + wd*p (2), two squares, two sums; the
# LARS update g + wd*p (2), mu1*d, t*g', their difference, eta*d', p + .
SEG_SQ_FLOPS, LARS_FLOPS = 6, 7
BUCKET_BYTES = 64 * 1024 * 1024
# the sums are held relative to the sum of the magnitudes they add
# (reduction order); bn_apply and bn_bwd_dx bitwise
SUM_TOL = 1e-5


# what every worker process imports: the phases' processes fork from a
# server that imported them once (``spawn``)
WORKER_PRELOAD = ("torch", "torch.distributed", "repro_torch.launch.train",
                  "repro_torch.launch.serve", "repro_torch.analysis.audit")


def spawn(fn, args, nprocs: int) -> None:
    """``torch.multiprocessing.spawn`` of ``fn(rank, *args)`` through
    multiprocessing's fork server, which imported ``WORKER_PRELOAD`` once
    (``main``) and touched no CUDA device: a phase's processes start in a
    fraction of a second instead of importing torch anew. Raises as
    ``spawn`` does if a process fails."""
    import torch.multiprocessing as mp
    mp.start_processes(fn, args=args, nprocs=nprocs,
                       start_method="forkserver")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bn_sites(cfg, batch: int):
    """(name, rows, C, relu, residual) of every BN site of the ResNet, in
    forward order, from the model's SAME-padding arithmetic."""
    w = cfg.conv_width
    s = -(-cfg.image_size // 2)  # stem conv, stride 2
    sites = [("stem/bn", batch * s * s, w, True, False)]
    s = -(-s // 2)  # max-pool, stride 2
    for si, blocks in enumerate(cfg.conv_stages):
        mid, c_out = w * 2 ** si, w * 2 ** si * 4
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            s_out = -(-s // stride)
            pre = f"stage{si}/block{bi}"
            if bi == 0:
                sites.append((f"{pre}/proj_bn", batch * s_out ** 2, c_out,
                              False, False))
            sites.append((f"{pre}/bn1", batch * s * s, mid, True, False))
            sites.append((f"{pre}/bn2", batch * s_out ** 2, mid, True,
                          False))
            sites.append((f"{pre}/bn3", batch * s_out ** 2, c_out, True,
                          True))
            s = s_out
    return sites


def time_ms(torch, fn, iters: int = 10, trials: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls are captured
    into a CUDA graph and the replays timed with CUDA events (median of
    ``trials``), so the host's dispatch cost is left out. Inputs stay in
    L2 between calls where they fit (50 MB)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


_L2_FLUSH = {}


def time_cold_ms(torch, fn, samples: int = 21) -> float:
    """Device time of one call of ``fn`` with nothing of its inputs in
    L2: a read of 256 MiB (five times the card's 50 MB L2; a read, so
    that no dirty line is written back during the call) runs before
    each call, and CUDA events around the call alone time it (median of
    ``samples``; the flush keeps the card busy while the host queues
    the call)."""
    if "buf" not in _L2_FLUSH:
        _L2_FLUSH["buf"] = torch.ones(1 << 26, dtype=torch.int32,
                                      device="cuda")
    buf = _L2_FLUSH["buf"]
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(samples)]
    for start, end in marks:
        buf.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def time_eager_ms(torch, fn, iters: int = 5) -> float:
    """Device time of one call of ``fn`` where it cannot be captured in a
    graph (it reads values on the host): ``iters`` calls between two
    CUDA events, their host waits included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def site_bytes(rows: int, c: int, esize: int, relu: bool, res: bool):
    """Bytes each kernel must move at one site: every input read once,
    every output written once (per-channel vectors in f32)."""
    act = rows * c * esize
    return {
        "bn_stats": act + 2 * c * 4,
        "bn_apply": act * (2 + res) + 4 * c * 4,
        "bn_bwd_sums": act * (2 + relu) + 4 * c * 4,
        # mu, rstd, scale, s1, s2 (no mean / var cotangents on the path)
        "bn_bwd_dx": act * (3 + relu + res) + 5 * c * 4,
    }


def kernel_phase(torch, fb, cfg, out_rows):
    """Every kernel at every distinct site shape, bf16 and f32. Returns
    per-step totals over the 53 sites (bf16, the main path's dtype)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    groups = {}
    for _, rows, c, relu, res in bn_sites(cfg, BATCH):
        key = (rows, c, relu, res)
        groups[key] = groups.get(key, 0) + 1
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "library_ms": 0.0, "max_abs_err": 0.0} for k in KERNELS}
    pair = {"fwd_ms": 0.0, "fwd_library_ms": 0.0, "bwd_ms": 0.0,
            "bwd_library_ms": 0.0, "bwd_library_same_ms": 0.0,
            # the sites with neither ReLU nor residual, where PyTorch's
            # sync-BN pieces compute what bn_bwd_sums / bn_bwd_dx do
            "plain_sites_bwd_sums_ms": 0.0, "backward_reduce_ms": 0.0,
            "plain_sites_bwd_dx_ms": 0.0, "backward_elemt_ms": 0.0}
    gen = torch.Generator(device=dev).manual_seed(0)
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        esize = 2 if dtype == torch.bfloat16 else 4
        for (rows, c, relu, res), count in sorted(groups.items()):
            def rnd(*shape, dt=dtype, gen=gen):
                return (torch.randn(*shape, generator=gen, device=dev) * 2
                        + 0.5).to(dt)

            x, dy = rnd(rows, c), rnd(rows, c)
            r = rnd(rows, c) if res else None
            scale = 1 + 0.1 * rnd(c, dt=torch.float32)
            bias = 0.1 * rnd(c, dt=torch.float32)
            mean, var = fb.bn_stats(x)
            pmean, pvar = fb.PLAIN["bn_stats"](x)
            rstd = torch.rsqrt(pvar + 1e-5)
            a = rstd * scale
            o = bias - pmean * a
            y = fb.bn_apply(x, a, o, r, relu)
            py = fb.PLAIN["bn_apply"](x, a, o, r, relu)
            s1, s2 = fb.bn_bwd_sums(dy, x, py, pmean, rstd, relu)
            p1, p2 = fb.PLAIN["bn_bwd_sums"](dy, x, py, pmean, rstd, relu)
            inv_m = 1.0 / rows
            dx_args = (dy, x, py, pmean, rstd, scale, p1, p2, None, None,
                       inv_m, relu, res)
            cot = (rnd(c, dt=torch.float32), rnd(c, dt=torch.float32))
            # the same site with mean / var cotangents, in given-stats
            # mode, and as one of two workers' cross-replica site (the
            # count 2 x rows, with cotangents: the dvar term divides by it)
            dx_cases = {"": (dx_args, {}),
                        " cotangents": (dx_args[:8] + cot + dx_args[10:],
                                        {}),
                        " given stats": (dx_args[:6] + (None,) * 4
                                         + dx_args[10:], {}),
                        " count 2m": (dx_args[:8] + cot
                                      + (1.0 / (2 * rows), relu, res),
                                      {"count": 2 * rows})}
            torch.cuda.synchronize()
            # --- hold each kernel against its plain version
            x32 = x.float()
            dym = dy.float() if not relu else torch.where(
                py > 0, dy.float(), torch.zeros((), device=dev))
            xhat = (x32 - pmean) * rstd
            errs = {}

            def sum_err(name, got, want, mag):
                bad = ((got - want).abs() / (mag + 1e-30)).max().item()
                if not bad <= SUM_TOL:
                    raise AssertionError(
                        f"{name} {dname} rows={rows} C={c}: error "
                        f"{bad:.3g} of the summed magnitude > {SUM_TOL}")
                return (got - want).abs().max().item()

            again = fb.bn_stats(x)  # one launch, merged by its last block
            if not (torch.equal(again[0], mean)
                    and torch.equal(again[1], var)):
                raise AssertionError(f"bn_stats {dname} rows={rows} C={c}: "
                                     f"not the same bits on a second launch")
            errs["bn_stats"] = max(
                sum_err("bn_stats mean", mean, pmean,
                        x32.abs().mean(0)),
                sum_err("bn_stats var", var, pvar,
                        (x32 - pmean).square().mean(0)))
            errs["bn_bwd_sums"] = max(
                sum_err("bn_bwd_sums S1", s1, p1, dym.abs().sum(0)),
                sum_err("bn_bwd_sums S2", s2, p2, (dym * xhat).abs().sum(0)))
            # bn_apply rounds each op once in the plain version's order
            if not torch.equal(y, py):
                raise AssertionError(
                    f"bn_apply {dname} rows={rows} C={c}: not bitwise equal"
                    f" to its plain version (max error "
                    f"{(y.float() - py.float()).abs().max().item():.3g})")
            errs["bn_apply"] = 0.0
            # so does bn_bwd_dx, its coefficients included
            for case, (args, kw) in dx_cases.items():
                got = fb.bn_bwd_dx(*args, **kw)
                want = fb.PLAIN["bn_bwd_dx"](*args, **kw)
                for name, g, w in (("dx", got[0], want[0]),
                                   ("dres", got[1], want[1])):
                    if (g is None) != (w is None) or (
                            g is not None and not torch.equal(g, w)):
                        err = (g.float() - w.float()).abs().max().item() \
                            if g is not None and w is not None else None
                        raise AssertionError(
                            f"bn_bwd_dx {name}{case} {dname} rows={rows} "
                            f"C={c}: not bitwise equal to its plain version "
                            f"(max error {err})")
            errs["bn_bwd_dx"] = 0.0
            # --- times: kernel, plain version, library yardstick
            calls = {
                "bn_stats": (lambda: fb.bn_stats(x),
                             lambda: fb.PLAIN["bn_stats"](x),
                             lambda: torch.var_mean(x, 0, correction=0)),
                "bn_apply": (lambda: fb.bn_apply(x, a, o, r, relu),
                             lambda: fb.PLAIN["bn_apply"](x, a, o, r, relu),
                             lambda: F.batch_norm(x, lm, lv, lw, lb,
                                                  training=False)),
                "bn_bwd_sums": (
                    lambda: fb.bn_bwd_sums(dy, x, py, pmean, rstd, relu),
                    lambda: fb.PLAIN["bn_bwd_sums"](dy, x, py, pmean, rstd,
                                                    relu), None),
                "bn_bwd_dx": (lambda: fb.bn_bwd_dx(*dx_args),
                              lambda: fb.PLAIN["bn_bwd_dx"](*dx_args), None),
            }
            # the yardsticks take their per-channel vectors in x's dtype
            lw, lb, lm, lv = (t.to(dtype) for t in (scale, bias, pmean,
                                                     pvar))
            nbytes = site_bytes(rows, c, esize, relu, res)
            row = {"dtype": dname, "rows": rows, "C": c, "relu": relu,
                   "residual": res, "sites": count}
            for k, (kern, plain, lib) in calls.items():
                row[k] = {
                    "ms": time_ms(torch, kern),
                    "plain_ms": time_ms(torch, plain),
                    "library_ms": (time_ms(torch, lib) if lib is not None
                                   else None),
                    "bound_ms": nbytes[k] / HBM_BYTES_PER_S * 1e3,
                    "max_abs_err": errs[k],
                }
            # bn_stats against the one call that computes its mean and
            # inverse std
            row["bn_stats"]["batch_norm_stats_ms"] = time_ms(
                torch, lambda: torch.batch_norm_stats(x, 1e-5))
            # the site pair against PyTorch's batch norm (training) forward
            # and its backward, one call each; the backward also with the
            # ReLU's threshold_backward in front at the ReLU sites (the
            # library's version of the same function: the residual's
            # gradient is the masked dy itself)
            _, smean, sinv = torch.ops.aten.native_batch_norm(
                x, lw, lb, None, None, True, 0.1, 1e-5)

            def bwd_same():
                g = (torch.ops.aten.threshold_backward(dy, py, 0)
                     if relu else dy)
                return torch.ops.aten.native_batch_norm_backward(
                    g, x, lw, None, None, smean, sinv, True, 1e-5,
                    [True, True, True])

            row["pair"] = {
                "fwd_ms": row["bn_stats"]["ms"] + row["bn_apply"]["ms"],
                "fwd_library_ms": time_ms(
                    torch, lambda: torch.ops.aten.native_batch_norm(
                        x, lw, lb, None, None, True, 0.1, 1e-5)),
                "bwd_ms": row["bn_bwd_sums"]["ms"] + row["bn_bwd_dx"]["ms"],
                "bwd_library_ms": time_ms(
                    torch, lambda: torch.ops.aten.native_batch_norm_backward(
                        dy, x, lw, None, None, smean, sinv, True, 1e-5,
                        [True, True, True])),
                "bwd_library_same_ms": time_ms(torch, bwd_same),
            }
            if not relu and not res:
                # the sync-BN pieces: S1 / S2, then dx from the same sums
                # bn_bwd_dx is given (sum_dy_xmu = S2 / rstd) and the same
                # mean, inverse std and weight
                sdy, sdx = p1, p2 / rstd
                cnt = torch.full((1,), rows, dtype=torch.int32, device=dev)
                row["pair"].update(
                    backward_reduce_ms=time_ms(
                        torch, lambda: torch.batch_norm_backward_reduce(
                            dy, x, smean, sinv, scale, True, False, False)),
                    backward_elemt_ms=time_ms(
                        torch, lambda: torch.batch_norm_backward_elemt(
                            dy, x, pmean, rstd, scale, sdy, sdx, cnt)))
            out_rows.append(row)
            log(f"  {dname:4s} rows={rows:7d} C={c:5d} relu={int(relu)} "
                f"res={int(res)} x{count:2d}  " + "  ".join(
                    f"{k}={row[k]['ms'] * 1e3:7.1f}us"
                    f"(plain {row[k]['plain_ms'] * 1e3:7.1f},"
                    f" bound {row[k]['bound_ms'] * 1e3:6.1f})"
                    for k in KERNELS))
            for k in KERNELS:
                totals[k]["max_abs_err"] = max(totals[k]["max_abs_err"],
                                               errs[k])
                if dname == "bf16":
                    for f in ("ms", "plain_ms", "bound_ms"):
                        totals[k][f] += count * row[k][f]
                    lib = row[k]["library_ms"]
                    totals[k]["library_ms"] = (
                        None if lib is None or totals[k]["library_ms"] is None
                        else totals[k]["library_ms"] + count * lib)
            if dname == "bf16":
                totals["bn_stats"]["batch_norm_stats_ms"] = (
                    totals["bn_stats"].get("batch_norm_stats_ms", 0.0)
                    + count * row["bn_stats"]["batch_norm_stats_ms"])
                pr = dict(row["pair"])
                if "backward_reduce_ms" in pr:
                    pr["plain_sites_bwd_sums_ms"] = row["bn_bwd_sums"]["ms"]
                    pr["plain_sites_bwd_dx_ms"] = row["bn_bwd_dx"]["ms"]
                for f in pair:
                    pair[f] += count * pr.get(f, 0.0)
    return totals, pair


def division_check(torch, n: int = 1 << 20):
    """How ATen divides a CUDA f32 tensor by a Python float m (why
    ``bn_bwd_dx`` takes 1 / m from the host, as its plain version on
    the CPU does): the elements whose bits differ from t * f32(1 / m)
    and from the true division t / m (by a tensor of m), at m = 401,408
    (the stem's rows) and 1,568."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    t = torch.randn(n, generator=gen, device="cuda")
    out = {}
    for m in (401408, 1568):
        by_scalar = t / float(m)
        out[m] = {
            "differs_from_times_reciprocal": int(
                (by_scalar != t * (1.0 / m)).sum()),
            "differs_from_true_division": int(
                (by_scalar != t / torch.full_like(t, m)).sum()),
            "elements": n}
    return out


def bound(nbytes: float, flops: float):
    """(bound ms, what bounds it): the larger of the bytes over the HBM
    rate and the float32 operations over the card's float32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def model_params(cfg):
    """The parameters of the port's own ResNet, built on the CPU."""
    from repro_torch.models import build_model
    model = build_model(cfg, device="cpu")
    return {k: p.detach() for k, p in model.named_parameters()}


def model_leaves(params):
    """(name, elements, decays) of every parameter leaf."""
    from repro_torch.optim.rmsprop_warmup import decays
    return [(k, p.numel(), decays(k)) for k, p in params.items()]


def _bitwise(name: str, got, want) -> None:
    """Raise unless ``got`` equals ``want`` bit for bit (same dtype and
    shape, every element equal)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    if not bool((got == want).all()):
        diff = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version by up to {diff:.3g}")


def leaf_tensors(torch, leaves, gen, offset: int = 0, extra=()):
    """Per-leaf p, d and m (each its own allocation, as parameters and
    state are) and g as views into one stream ``offset`` elements into
    its buffer (as ``unpack`` hands the gradients over), for leaves of
    the given sizes plus ``extra`` sizes."""
    dev = torch.device("cuda")
    sizes = [n for _, n, _ in leaves] + list(extra)
    buf = torch.randn(offset + sum(sizes), generator=gen, device=dev) * 1e-3
    gs, ps, ds, ms, lo = [], [], [], [], offset
    for n in sizes:
        gs.append(buf[lo:lo + n])
        lo += n
        ps.append(torch.randn(n, generator=gen, device=dev) * 0.05)
        ds.append(torch.randn(n, generator=gen, device=dev) * 1e-3)
        m = torch.rand(n, generator=gen, device=dev) * 1e-6
        m[:n // 4] = 0.0  # the state of the first step
        ms.append(m)
    return gs, ps, ds, ms


def update_phase(torch, leaves, wd: float):
    """``hybrid_update`` bitwise against its plain version: the one-leaf
    entry at every distinct leaf size and the whole stream (decay none,
    scalar and a stream), the multi-leaf entry over all leaves at once
    (decay none and per leaf, gradients as views 0, 1 and 2 elements
    into one stream, and a one-element leaf), each with a_sgd 0, 0.5 and
    1. Timed per main-path step as the one launch over every leaf, with
    the earlier design (one launch per leaf) beside it."""
    from collections import Counter

    from repro_torch.core.optimizer import HybridHyper
    from repro_torch.kernels import fused_update as fu
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    total = sum(n for _, n, _ in leaves)

    def tensors(n):
        g = torch.randn(n, generator=gen, device=dev) * 1e-3
        p = torch.randn(n, generator=gen, device=dev) * 0.05
        d = torch.randn(n, generator=gen, device=dev) * 1e-3
        m = torch.rand(n, generator=gen, device=dev) * 1e-6
        m[:n // 4] = 0.0  # the state of the first step
        return g, p, d, m

    sizes = sorted({n for _, n, _ in leaves} | {total})
    for n in sizes:
        g, p, d, m = tensors(n)
        stream = (torch.rand(n, generator=gen, device=dev) < 0.5).float() * wd
        for dname, dec in (("none", 0.0), ("scalar", wd), ("stream", stream)):
            for a_sgd in (0.0, 0.5, 1.0):
                h = HybridHyper(eta=0.1, alpha_sgd=a_sgd)
                kern = [t.clone() for t in (p, d, m)]
                plain = [t.clone() for t in (p, d, m)]
                fu.fused_hybrid_update(g, *kern, h, dec)
                fu.PLAIN["hybrid_update"](g, *plain, h, dec)
                for what, a, b in zip(("theta", "delta", "m"), kern, plain):
                    _bitwise(f"hybrid_update n={n} wd={dname} "
                             f"a_sgd={a_sgd} {what}", a, b)
    log(f"  hybrid_update one leaf bitwise at {len(sizes)} sizes (1 .. "
        f"{total}) x decay none/scalar/stream x a_sgd 0/0.5/1")
    per_leaf = [wd if dec else 0.0 for _, _, dec in leaves]
    for offset in (0, 1, 2):
        gs, ps, ds, ms = leaf_tensors(torch, leaves, gen, offset, extra=(1,))
        for dname, wds in (("none", [0.0] * len(gs)),
                           ("per leaf", per_leaf + [wd])):
            for a_sgd in (0.0, 0.5, 1.0):
                h = HybridHyper(eta=0.1, alpha_sgd=a_sgd)
                kern = [[t.clone() for t in ts] for ts in (ps, ds, ms)]
                plain = [[t.clone() for t in ts] for ts in (ps, ds, ms)]
                fu.reset_launch_counts()
                fu.fused_hybrid_update_leaves(gs, *kern, h, wds)
                launches = fu.LAUNCHES["hybrid_update"]
                assert launches == 1, launches
                for i, g in enumerate(gs):
                    fu.PLAIN["hybrid_update"](g, plain[0][i], plain[1][i],
                                              plain[2][i], h, wds[i])
                for what, ka, pa in zip(("theta", "delta", "m"), kern,
                                        plain):
                    for i, (a, b) in enumerate(zip(ka, pa)):
                        _bitwise(f"hybrid_update_leaves leaf {i} "
                                 f"g offset {offset} wd={dname} "
                                 f"a_sgd={a_sgd} {what}", a, b)
        del gs, ps, ds, ms, kern, plain
    log(f"  hybrid_update {len(leaves)} leaves + a 1-element leaf in one "
        f"launch, bitwise per leaf, g views 0/1/2 elements into one stream "
        f"x decay none/per leaf x a_sgd 0/0.5/1")
    h = HybridHyper(eta=0.1, alpha_sgd=0.0)
    gs, ps, ds, ms = leaf_tensors(torch, leaves, gen)
    out = {"ms": time_ms(torch, lambda: fu.fused_hybrid_update_leaves(
               gs, ps, ds, ms, h, per_leaf)),
           "per_leaf_ms": 0.0, "plain_ms": 0.0, "library_ms": None,
           "max_abs_err": 0.0}
    del gs, ps, ds, ms
    nbytes = flops = 0
    for (n, dec), count in sorted(Counter((n, dec)
                                          for _, n, dec in leaves).items()):
        g, p, d, m = tensors(n)
        w = wd if dec else 0.0
        out["per_leaf_ms"] += count * time_ms(
            torch, lambda: fu.fused_hybrid_update(g, p, d, m, h, w))
        out["plain_ms"] += count * time_ms(
            torch, lambda: fu.PLAIN["hybrid_update"](g, p, d, m, h, w))
        nbytes += count * 28 * n  # read g, p, d, m; write p, d, m
        flops += count * UPDATE_FLOPS * n
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops)
    g, p, d, m = tensors(total)
    out["one_launch_stream_ms"] = time_ms(
        torch, lambda: fu.fused_hybrid_update(g, p, d, m, h, wd))
    # the per-element decay stream (the _kernel_wd variant) over the
    # whole stream: read g, p, d, m, wd; write p, d, m
    wds = torch.cat([torch.full((n,), wd if dec else 0.0, device=dev)
                     for _, n, dec in leaves])
    out["wd_stream_ms"] = time_ms(
        torch, lambda: fu.fused_hybrid_update(g, p, d, m, h, wds))
    out["wd_stream_plain_ms"] = time_ms(
        torch, lambda: fu.PLAIN["hybrid_update"](g, p, d, m, h, wds))
    out["wd_stream_bound_ms"], _ = bound(32 * total,
                                         (UPDATE_FLOPS + 2) * total)
    log(f"  hybrid_update per step ({len(leaves)} leaves, {total} "
        f"elements): {out['ms']:.3f} ms in one launch (one launch per leaf "
        f"{out['per_leaf_ms']:.3f}, plain {out['plain_ms']:.3f}, bound "
        f"{out['bound_ms']:.3f}); the whole stream as one leaf "
        f"{out['one_launch_stream_ms']:.3f} ms; with the decay stream "
        f"{out['wd_stream_ms']:.3f} ms (plain "
        f"{out['wd_stream_plain_ms']:.3f}, bound "
        f"{out['wd_stream_bound_ms']:.3f})")
    return out, total


def update_host_phase(torch, params_cpu, steps: int = 20):
    """Host time of one ``optimizer.update`` call (fused, f32 state) at
    main path 2's shapes: the parameters on the card, the gradients as
    views into one stream as ``unpack`` gives them. The earlier design,
    one ``fused_hybrid_update`` call per leaf as the optimizer's loop
    made them (the decay found from the name, the casts, the checks, a
    launch), is timed beside it. The host clock runs from a synchronized
    device to the call's return (the launches are asynchronous)."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.core.optimizer import HybridHyper
    from repro_torch.kernels import fused_update as fu
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.rmsprop_warmup import decays

    dev = torch.device("cuda")
    cfg = OptimizerConfig()
    params = {k: v.to(dev).clone() for k, v in params_cpu.items()}
    stream = torch.randn(sum(p.numel() for p in params.values()),
                         device=dev) * 1e-3
    grads, lo = {}, 0
    for k, p in params.items():
        grads[k] = stream[lo:lo + p.numel()].view(p.shape)
        lo += p.numel()
    opt = make_optimizer(cfg, STEPS, BATCH, use_fused=True)
    state = opt.init(params)
    h = HybridHyper(eta=0.1, alpha_sgd=0.0)

    def per_leaf():
        for k, p in params.items():
            d, m = state["delta"][k], state["m"][k]
            w = cfg.weight_decay if decays(k) else 0.0
            d32, m32 = d.float(), m.float()
            fu.fused_hybrid_update(grads[k].float().contiguous(), p, d32,
                                   m32, h, w)

    def host_ms(fn):
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    def one_launch():
        opt.update(params, grads, state)

    out = {"one_launch_host_ms": [], "per_leaf_host_ms": []}
    for name, fn in (("one_launch", one_launch), ("per_leaf", per_leaf),
                     ("per_leaf", per_leaf), ("one_launch", one_launch)):
        out[f"{name}_host_ms"].append(host_ms(fn))
    fu.reset_launch_counts()
    opt.update(params, grads, state)
    out["launches_per_update"] = fu.LAUNCHES["hybrid_update"]
    assert out["launches_per_update"] == 1, out
    log(f"  optimizer.update host time ({len(params)} leaves, median of "
        f"{steps} calls, in turns): one launch {out['one_launch_host_ms']} "
        f"ms, one launch per leaf {out['per_leaf_host_ms']} ms")
    return out


def cast_phase(torch, total: int, sizes=None):
    """``cast_copy`` (``pack_cast`` / ``unpack_cast``) bitwise against
    ``Tensor.to`` at odd lengths and the whole stream, to bf16 and f16
    and back; timed as one pack and one unpack of the bf16 stream. With
    the leaf ``sizes`` of the stream, also the sync's one-pass ends
    (``onepass_phase``)."""
    from repro_torch.kernels import bucket_ops as bo
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    lengths = (1, 7, 127, 8 * 16384 + 3, total)
    for n in lengths:
        for offset in (0, 1, 2):  # elements into the buffer
            buf = torch.randn(n + offset, generator=gen, device=dev) * 3
            x = buf[offset:]
            # overflow, underflow and subnormals of the half formats
            edge = torch.tensor([7e4, -1e5, 1e-8, -3e-6, 6.1e-5, 3e38, 1e-40,
                                 0.0], device=dev)[:n]
            x[:edge.numel()] = edge
            for wire in (bf16, torch.float16):
                what = f"n={n} offset={offset} {wire}"
                packed = bo.pack_cast(x, wire)
                _bitwise(f"pack_cast {what}", packed, x.to(wire))
                wbuf = torch.empty(n + offset, dtype=wire, device=dev)
                wbuf[offset:] = packed
                _bitwise(f"unpack_cast {what}", bo.unpack_cast(
                    wbuf[offset:]), packed.to(f32))
            del buf, x
    log(f"  cast_copy bitwise at n = {', '.join(map(str, lengths))}, each "
        f"0, 1 and 2 elements into its buffer, bf16 and f16, both ways")
    x = torch.randn(total, generator=gen, device=dev)
    w = x.to(bf16)
    out = {
        "ms": time_ms(torch, lambda: bo.pack_cast(x, bf16))
        + time_ms(torch, lambda: bo.unpack_cast(w)),
        "plain_ms": time_ms(torch, lambda: bo.PLAIN["cast_copy"](x, bf16))
        + time_ms(torch, lambda: bo.PLAIN["cast_copy"](w, f32)),
        "library_ms": time_ms(torch, lambda: x.to(bf16))
        + time_ms(torch, lambda: w.to(f32)),
        "max_abs_err": 0.0}
    out["bound_ms"], out["bound_by"] = bound(2 * 6 * total, 0)
    log(f"  cast_copy per step (pack + unpack, {total} elements): "
        f"{out['ms']:.3f} ms (plain {out['plain_ms']:.3f}, Tensor.to "
        f"{out['library_ms']:.3f}, bound {out['bound_ms']:.3f})")
    if sizes is not None:
        del w
        out["onepass"] = onepass_phase(torch, x, sizes)
    return out


def onepass_phase(torch, x, sizes, pad: int = 3):
    """The bucketed sync's two ends, each one launch (``pack_leaves``,
    ``unpack_buckets``), against the sequence they replace (the plain
    versions on the card: ``torch.cat``, ``Tensor.to``, the pad; the
    buckets' ``torch.cat``, ``Tensor.to``, ``/ n``, ``.square().sum()``)
    over the stream ``x`` cut into leaves of ``sizes`` (views, as the
    leaves sit at their stream offsets) and 64 MiB buckets: bitwise in
    bf16 and f16 (n = 1 and 3), the norm within rtol 1e-5 of a float64
    sum and the same bits twice; one launch each; timed at n = 1, the
    world size of the benchmark's cells, with the norm."""
    from repro_torch.kernels import bucket_ops as bo
    total = x.numel()
    assert sum(sizes) == total, (sum(sizes), total)
    bounds = [0]
    for n in sizes:
        bounds.append(bounds[-1] + n)
    leaves = [x[lo:hi] for lo, hi in zip(bounds, bounds[1:])]

    def cut(stream, wire):
        step = BUCKET_BYTES // wire.itemsize
        return [stream[lo:lo + step] for lo in range(0, stream.numel(), step)]

    for wire in (torch.bfloat16, torch.float16):
        bo.reset_launch_counts()
        packed = bo.pack_leaves(leaves, wire, pad)
        _bitwise(f"pack_leaves {wire}", packed,
                 bo.PLAIN["pack_leaves"](leaves, wire, pad))
        buckets = cut(packed, wire)
        for denom in (1, 3):
            got, sq = bo.unpack_buckets(buckets, total, denom, True)
            want, _ = bo.PLAIN["unpack_buckets"](buckets, total, denom)
            _bitwise(f"unpack_buckets {wire} n={denom}", got, want)
            del got
            _, sq2 = bo.unpack_buckets(buckets, total, denom, True)
            _bitwise(f"unpack_buckets norm {wire} n={denom} twice", sq, sq2)
            ref = sum(float(c.double().square().sum())
                      for c in want.split(1 << 26))
            del want
            assert abs(float(sq) - ref) <= 1e-5 * ref, (
                f"unpack_buckets norm {wire} n={denom}", float(sq), ref)
        assert bo.ENTRY_LAUNCHES == {"cast_copy": 0, "pack_leaves": 1,
                                     "unpack_buckets": 4}, bo.ENTRY_LAUNCHES
        del packed, buckets
    bf16 = torch.bfloat16
    w = bo.pack_leaves(leaves, bf16, pad)
    buckets = cut(w, bf16)
    big = dict(iters=3, trials=3) if total > 1e8 else {}
    out = {
        "leaves": len(sizes), "buckets": len(buckets), "elements": total,
        "pack_ms": time_ms(torch, lambda: bo.pack_leaves(leaves, bf16, pad),
                           **big),
        "unpack_ms": time_ms(torch, lambda: bo.unpack_buckets(
            buckets, total, 1, True), **big),
        "plain_pack_ms": time_ms(torch, lambda: bo.PLAIN["pack_leaves"](
            leaves, bf16, pad), **big),
        "plain_unpack_ms": time_ms(torch, lambda: bo.PLAIN["unpack_buckets"](
            buckets, total, 1, True), **big)}
    out["ms"] = out["pack_ms"] + out["unpack_ms"]
    out["plain_ms"] = out["plain_pack_ms"] + out["plain_unpack_ms"]
    out["bound_ms"], out["bound_by"] = bound(2 * 6 * total, 0)
    log(f"  one-pass ends ({len(sizes)} leaves, {len(buckets)} buckets, "
        f"{total} elements), bitwise bf16 / f16, n = 1 and 3: pack "
        f"{out['pack_ms']:.3f} + unpack with the norm {out['unpack_ms']:.3f}"
        f" = {out['ms']:.3f} ms ({100 * out['bound_ms'] / out['ms']:.1f}% "
        f"of bound {out['bound_ms']:.3f}); the sequence they replace "
        f"{out['plain_pack_ms']:.3f} + {out['plain_unpack_ms']:.3f} = "
        f"{out['plain_ms']:.3f}")
    return out


# (shape, elements into the input's buffer) of input_train's edge cases:
# rows of 15 elements (no 16-byte access either side), C = 1 and C = 4
# (the run-time channel loop), rows of 24 (16-byte loads and stores; H 9
# leaves a block of one row), and the same with the input 4 bytes off
# alignment (element loads)
INPUT_EDGE_CASES = (((2, 7, 5, 3), 0), ((2, 7, 5, 1), 0), ((2, 7, 5, 4), 0),
                    ((3, 9, 8, 3), 0), ((3, 9, 8, 3), 1))
# (flip, dy(H), dx(W)) of the edge cases' samples, taken in turn
INPUT_EDGE_SHIFTS = (
    (1, lambda h: 3 * h, lambda w: w), (0, lambda h: -3 * h, lambda w: -w),
    (1, lambda h: h + 1, lambda w: w + 1),
    (0, lambda h: -(h + 1), lambda w: -(w + 1)),
    (1, lambda h: -3 * h, lambda w: w + 1),
    (0, lambda h: 3 * h + 2, lambda w: -(w + 1)),
    (1, lambda h: 0, lambda w: 0), (0, lambda h: 2, lambda w: -3))


def input_phase(torch, cfg):
    """``input_train`` and ``input_eval`` bitwise against their plain
    versions at the main path's batch, float32 pixels in and bf16 / f32
    out, with a table holding +-4 shifts and flips; timed in bf16."""
    from repro_torch.kernels import fused_input as fi
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    s = cfg.image_size
    x = torch.randn(BATCH, s, s, 3, generator=gen, device=dev) * 50 + 120
    table = torch.from_numpy(fi.input_augment_params(0, 5, BATCH)).to(dev)
    table[:4] = torch.tensor([[1, 4, -4, 0], [0, -4, 4, 0], [1, 0, 0, 0],
                              [1, -4, -4, 0]], dtype=torch.int32)
    mean = torch.tensor([123.7, 116.3, 103.5], device=dev)
    inv = 1.0 / torch.tensor([58.4, 57.1, 57.4], device=dev)
    for dt in (torch.bfloat16, torch.float32):
        _bitwise(f"input_train {dt}",
                 fi.fused_input_train(x, table, mean, inv, out_dtype=dt),
                 fi.PLAIN["input_train"](x, table, mean, inv, dt))
        _bitwise(f"input_eval {dt}",
                 fi.fused_input_eval(x, mean, inv, out_dtype=dt),
                 fi.PLAIN["input_eval"](x, mean, inv, dt))
    log(f"  input_train / input_eval bitwise at {tuple(x.shape)}, bf16 "
        f"and f32 out")
    for shape, offset in INPUT_EDGE_CASES:
        b, h, w, c = shape
        rows = [[f, dy(h), dx(w), 0] for f, dy, dx in INPUT_EDGE_SHIFTS]
        buf = torch.randn(offset + b * h * w * c, generator=gen,
                          device=dev) * 50 + 120
        xe = buf[offset:].view(shape)
        me = torch.linspace(100.0, 130.0, c, device=dev)
        ie = 1.0 / torch.linspace(50.0, 60.0, c, device=dev)
        for lo in range(0, len(rows), b):
            te = torch.tensor((rows * b)[lo:lo + b], dtype=torch.int32,
                              device=dev)
            for dt in (torch.bfloat16, torch.float32, torch.float16):
                _bitwise(f"input_train {shape} offset {offset} table "
                         f"{te.tolist()} {dt}",
                         fi.fused_input_train(xe, te, me, ie, out_dtype=dt),
                         fi.PLAIN["input_train"](xe, te, me, ie, dt))
    log(f"  input_train bitwise at {[s for s, _ in INPUT_EDGE_CASES]} "
        f"(input offsets {[o for _, o in INPUT_EDGE_CASES]} elements), "
        f"shifts of +-W, +-(W+1), +-3H with and without flips, bf16 / f32 "
        f"/ f16 out")
    bf16, n = torch.bfloat16, x.numel()
    out = {}
    for name, kern, plain in (
            ("input_train",
             lambda: fi.fused_input_train(x, table, mean, inv,
                                          out_dtype=bf16),
             lambda: fi.PLAIN["input_train"](x, table, mean, inv, bf16)),
            ("input_eval",
             lambda: fi.fused_input_eval(x, mean, inv, out_dtype=bf16),
             lambda: fi.PLAIN["input_eval"](x, mean, inv, bf16))):
        rec = {"ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
               "library_ms": None, "max_abs_err": 0.0}
        extra = BATCH * 16 if name == "input_train" else 0  # the table
        rec["bound_ms"], rec["bound_by"] = bound(n * 6 + extra + 24,
                                                 INPUT_FLOPS * n)
        out[name] = rec
        log(f"  {name} per call: {rec['ms']:.4f} ms (plain "
            f"{rec['plain_ms']:.4f}, bound {rec['bound_ms']:.4f})")
    return out


def lars_phase(torch, params, weight_decay: float):
    """``seg_sq_partials`` and ``lars_update`` against their plain
    versions and ``seg_sq_partials`` against a float64 sum, at
    ResNet-50's whole stream (the ``align=1`` plan of world size 1),
    the worker slices of an ``align=4`` plan for 2 and 4 workers, the
    whole stream with zero gradients, and edge cases; every case is
    timed. Returns the records of the whole stream (the main path's
    shape at world size 1) and of every case."""
    from repro_torch.distributed.bucketing import (local_shard, plan_buckets,
                                                   segment_ids_stream)
    from repro_torch.kernels import fused_update as fu
    from repro_torch.optim.stream import decay_wd_stream, trust_mask_segments
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)

    def rnd(n, scale):
        return torch.randn(n, generator=gen, device=dev) * scale

    def stream(plan):
        n = plan.padded_total
        pgd = [rnd(n, 0.05), rnd(n, 1e-3), rnd(n, 1e-3)]
        for t in pgd:
            t[plan.total_elems:] = 0.0  # the pad holds zeros
        wd = torch.from_numpy(decay_wd_stream(params, plan,
                                              weight_decay)).to(dev)
        seg = torch.from_numpy(segment_ids_stream(plan)).to(dev)
        mask = torch.from_numpy(trust_mask_segments(params, plan)).to(dev)
        trust = torch.where(mask, torch.rand(mask.numel(), generator=gen,
                                             device=dev) * 1e-2, 1.0)
        return (*pgd, wd, seg, trust)

    cases = {}
    plan1 = plan_buckets(params, BUCKET_BYTES, "bf16", align=1)
    full = stream(plan1)
    cases["stream"] = full
    p, g, d, wd, seg, trust = full
    cases["stream_zero_grad"] = (p, torch.zeros_like(g), d, wd, seg, trust)
    plan4 = plan_buckets(params, BUCKET_BYTES, "bf16", align=4)
    whole4 = stream(plan4)
    for n in (2, 4):
        for w in range(n):
            cases[f"shard{w}of{n}"] = tuple(
                local_shard(t, plan4, n, w) if t.numel() == plan4.padded_total
                else t for t in whole4)
    # 1 element; an empty segment; 1-element segments; a segment across
    # the chunks of the first pass; a length not a multiple of 128
    for name, sizes in (("one_element", [1]),
                        ("edges", [1, 0, 1, 1, 5000, 4095, 1, 8193, 3])):
        n = sum(sizes)
        seg_e = torch.repeat_interleave(
            torch.arange(len(sizes), dtype=torch.int32, device=dev),
            torch.tensor(sizes, device=dev))
        trust_e = torch.rand(len(sizes), generator=gen, device=dev) * 1e-2
        trust_e[::2] = 1.0
        wd_e = (torch.rand(n, generator=gen, device=dev) < 0.5).float() \
            * weight_decay
        cases[name] = (rnd(n, 0.05), rnd(n, 1e-3), rnd(n, 1e-3), wd_e, seg_e,
                       trust_e)
    eta, mu1 = 0.1, 0.9
    records = {}
    for name, (p, g, d, wd, seg, trust) in cases.items():
        n, n_seg = p.numel(), trust.numel()
        got = fu.fused_segment_sq_partials(p, g, wd, seg, n_seg)
        again = fu.fused_segment_sq_partials(p, g, wd, seg, n_seg)
        plain = fu.PLAIN["seg_sq_partials"](p, g, wd, seg, n_seg)
        p64, ge64 = p.double(), g.double() + wd.double() * p.double()
        want = torch.zeros(2, n_seg, dtype=torch.float64, device=dev)
        want.index_add_(1, seg.long(), torch.stack([p64 * p64, ge64 * ge64]))
        repeat = torch.equal(got, again)
        rel = ((got.double() - want).abs() / want.clamp_min(1e-300)).max()
        if not (repeat and rel.item() <= 1e-5
                and bool((got[want == 0] == 0).all())):
            raise AssertionError(f"seg_sq_partials {name}: repeatable "
                                 f"{repeat}, rel err vs f64 {rel.item():.3g}")
        kern, ref = [p.clone(), d.clone()], [p.clone(), d.clone()]
        fu.fused_lars_update(g, *kern, wd, seg, trust, eta, mu1)
        fu.PLAIN["lars_update"](g, *ref, wd, seg, trust, eta, mu1)
        _bitwise(f"lars_update {name} p", kern[0], ref[0])
        _bitwise(f"lars_update {name} d", kern[1], ref[1])
        sq_bound, sq_by = bound(16 * n + 8 * n_seg, SEG_SQ_FLOPS * n)
        up_bound, up_by = bound(28 * n + 4 * n_seg, LARS_FLOPS * n)
        rec = {
            "elements": n, "segments": n_seg,
            "seg_sq_partials": {
                "ms": time_ms(torch, lambda: fu.fused_segment_sq_partials(
                    p, g, wd, seg, n_seg)),
                "plain_ms": time_eager_ms(
                    torch, lambda: fu.PLAIN["seg_sq_partials"](
                        p, g, wd, seg, n_seg)),
                "bound_ms": sq_bound, "bound_by": sq_by, "library_ms": None,
                "max_abs_err": (got - plain).abs().max().item(),
                "rel_err_f64": rel.item(), "repeatable": repeat},
            "lars_update": {
                "ms": time_ms(torch, lambda: fu.fused_lars_update(
                    g, kern[0], kern[1], wd, seg, trust, eta, mu1)),
                "plain_ms": time_ms(torch, lambda: fu.PLAIN["lars_update"](
                    g, ref[0], ref[1], wd, seg, trust, eta, mu1)),
                "bound_ms": up_bound, "bound_by": up_by, "library_ms": None,
                "max_abs_err": 0.0},
        }
        if name == "stream":  # a yardstick: index_add_ of the squares
            sq = torch.stack([p * p, (g + wd * p).square()])
            seg64 = seg.long()
            rec["index_add_ms"] = time_ms(
                torch, lambda: torch.zeros(2, n_seg, device=dev).index_add_(
                    1, seg64, sq))
        records[name] = rec
        r, u = rec["seg_sq_partials"], rec["lars_update"]
        log(f"  {name:16s} n={n:9d} segs={n_seg:3d}  seg_sq_partials "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f}; rel err vs f64 {r['rel_err_f64']:.2g}, "
            f"repeatable)  lars_update {u['ms']:.4f} ms (plain "
            f"{u['plain_ms']:.4f}, bound {u['bound_ms']:.4f}; bitwise)")
    log(f"  index_add_ of the precomputed squares (whole stream): "
        f"{records['stream']['index_add_ms']:.4f} ms")
    return {k: records["stream"][k] for k in LARS_KERNELS}, records


def reset_counts(libs) -> None:
    for lib in libs:
        lib.reset_launch_counts()


def read_counts(libs):
    return {k: v for lib in libs for k, v in lib.LAUNCHES.items()}


def check_state(torch, state, p0) -> None:
    """Every tensor of the train state on the card and finite, and every
    parameter changed by the steps."""
    tensors = list(state["params"].values())
    for v in state["opt"].values():  # per-leaf dicts, or flat streams
        tensors += list(v.values()) if isinstance(v, dict) else (
            [v] if torch.is_tensor(v) else [])
    for rec in state["model_state"].values():
        tensors += list(rec.values())
    assert all(t.device.type == "cuda" for t in tensors), "tensor off card"
    assert all(bool(torch.isfinite(t).all()) for t in tensors), \
        "non-finite state"
    changed = sum(not torch.equal(p0[k], v)
                  for k, v in state["params"].items())
    assert changed == len(p0), f"only {changed}/{len(p0)} params changed"


def main_path(torch, libs, cfg, steps: int):
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch.train import build_eval_setup, build_train_setup
    from repro_torch.training import Trainer, TrainerConfig

    t0 = time.perf_counter()
    model, state, train_step, data, _, _ = build_train_setup(
        cfg, global_batch=BATCH, seq_len=0, opt_cfg=OptimizerConfig(),
        steps_per_epoch=steps, compute_dtype=torch.bfloat16, fused_bn=True,
        compression="bf16", device="cuda")
    eval_step, val_data, finalize = build_eval_setup(
        model, cfg, global_batch=BATCH, seq_len=0)
    n_params = sum(p.numel() for p in state["params"].values())
    log(f"  setup {time.perf_counter() - t0:.1f}s: {n_params} parameters, "
        f"{len(state['model_state'])} BN sites")
    p0 = {k: v.clone() for k, v in state["params"].items()}
    tcfg = TrainerConfig(epochs=1, steps_per_epoch=steps,
                         eval_every_epochs=1, val_batches=1, log_every=1)
    trainer = Trainer(train_step, state, data, tcfg, eval_step=eval_step,
                      val_data=val_data, finalize_state=finalize)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts(libs)
    result = trainer.run()
    torch.cuda.synchronize()
    launches = read_counts(libs)
    state = result.state

    losses = [h["loss"] for h in result.history]
    log(f"  losses {losses}")
    assert len(losses) == steps and all(math.isfinite(v) for v in losses), \
        losses
    check_state(torch, state, p0)
    sites = len(state["model_state"])
    assert sites == 53, sites
    # slice 1's path runs the fused-BN kernels only
    want = {k: 0 for k in launches}
    want.update(bn_stats=sites * steps, bn_bwd_sums=sites * steps,
                bn_bwd_dx=sites * steps,
                bn_apply=sites * steps + sites * tcfg.val_batches)
    log(f"  launches {launches} (want {want})")
    assert launches == want, (launches, want)
    state, step_kernels = backward_kernel_check(torch, train_step, state,
                                                data, sites)
    ev = result.epoch_history[-1]
    assert math.isfinite(ev["loss"]) and 0.0 <= ev["top1"] <= 1.0, ev
    step_s = [h["time"] - h["data_wait"] for h in result.history[1:]]
    med = statistics.median(step_s)
    stats = {"steps": steps, "median_step_ms": med * 1e3,
             "images_per_s": BATCH / med,
             "median_wall_ms": statistics.median(
                 h["time"] for h in result.history[1:]) * 1e3,
             "step_ms": [t * 1e3 for t in step_s],
             "first_step_ms": (result.history[0]["time"]
                               - result.history[0]["data_wait"]) * 1e3,
             "data_ms_median": statistics.median(
                 h["data_wait"] for h in result.history) * 1e3,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "kernels_in_a_step": step_kernels,
             "eval": {k: ev[k] for k in ("top1", "loss")}}
    log(f"  median step {stats['median_step_ms']:.2f} ms, "
        f"{stats['images_per_s']:.1f} images/s (bf16, batch {BATCH}; "
        f"host wall time of the step, batch generation excluded); peak "
        f"{stats['peak_mem_gib']:.2f} GiB; eval {stats['eval']}")
    return launches, stats, (train_step, state, data)


# kernels per BN site per train step of the fused backward: bn_bwd_sums'
# two, bn_bwd_dx's one (the per-channel glue is inside its launch)
BWD_KERNELS = {"sums_partial": 1, "sums_merge": 1, "dx_kernel": 1}


def backward_kernel_check(torch, train_step, state, data, sites: int):
    """One more step under torch.profiler: the fused backward's kernels,
    counted by name, must be ``BWD_KERNELS`` per site. Returns the new
    state and the step's kernel count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = data.batch_at(2000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = train_step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    got = {k: sum(e.count for e in kernels if k in e.key)
           for k in BWD_KERNELS}
    want = {k: v * sites for k, v in BWD_KERNELS.items()}
    total = sum(e.count for e in kernels)
    log(f"  one more step under torch.profiler: {total} kernels, "
        f"backward BN kernels {got} (want {want})")
    assert got == want, (got, want)
    return state, total


def profile_phase(torch, train_step, state, data, steps: int = 3):
    """``--profile``: ``steps`` more main-path steps under torch.profiler.
    Returns the window's wall time, the summed device kernel time (one
    stream, so its busy time), and the top host ops and kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [data.batch_at(1000 + i) for i in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, metrics = train_step(state, b)
            float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:15]
    top_k = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    out = {
        "steps": steps, "wall_ms_per_step": wall / steps * 1e3,
        "device_busy_ms_per_step": device_s / steps * 1e3,
        "device_idle_share": 1.0 - device_s / wall if wall else None,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top_host_ops": [(e.key, e.count // steps,
                          e.self_cpu_time_total / steps / 1e3)
                         for e in host],
        "top_kernels": [(e.key[:90], e.count // steps,
                         e.self_device_time_total / steps / 1e3)
                        for e in top_k],
    }
    log(f"  per step: wall {out['wall_ms_per_step']:.2f} ms, device busy "
        f"{out['device_busy_ms_per_step']:.2f} ms (idle share "
        f"{out['device_idle_share']:.3f}), "
        f"{out['kernel_launches_per_step']:.0f} kernels")
    for name, n, ms in out["top_host_ops"]:
        log(f"    host {ms:8.3f} ms x{n:5d} {name}")
    for name, n, ms in out["top_kernels"]:
        log(f"    device {ms:8.3f} ms x{n:5d} {name}")
    return out


def param_rel_norm(a, b) -> float:
    """Relative norm of the difference of two parameter dicts, in
    float64: |a - b| / |b|."""
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return (num / den) ** 0.5


def reference_phase(torch):
    """Reduced ResNet, f32 on the card: the fused kernels against the
    unfused plain path, three train steps from one seed."""
    from repro_torch.configs import OptimizerConfig, get_config, \
        reduced_config
    from repro_torch.launch.train import build_train_setup

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(get_config("resnet50"))
    runs = {}
    for fused in (True, False):
        _, state, step, data, _, _ = build_train_setup(
            cfg, global_batch=16, seq_len=0, opt_cfg=OptimizerConfig(),
            steps_per_epoch=4, compute_dtype=torch.float32, fused_bn=fused,
            compression="bf16", seed=3, device="cuda")
        losses = []
        for i in range(3):
            state, metrics = step(state, data.batch_at(i))
            losses.append(float(metrics["loss"]))
        runs[fused] = (losses, state["params"])
    (lf, pf), (lu, pu) = runs[True], runs[False]
    rel = param_rel_norm(pf, pu)
    log(f"  fused {lf} vs unfused {lu}; param rel-norm diff {rel:.3g}")
    for a, b in zip(lf, lu):
        assert math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b), (lf, lu)
    assert rel < 1e-3, rel
    return {"fused_losses": lf, "unfused_losses": lu, "param_rel_norm": rel}


class PremadeSource:
    """A source whose batches are made before the run: the producer
    threads then only hand them over, so the step runs without them
    competing for the host."""

    def __init__(self, source, steps: int):
        self.batch = source.batch
        self.batches = [source.batch_at(i) for i in range(steps)]

    def batch_at(self, step: int):
        return self.batches[step]


def lars_recipe(steps: int, steps_per_epoch: int):
    """The ``lars_ls_poly`` recipe of the JAX package's
    ``examples/large_batch_sweep.py``: (optimizer config, label
    smoothing)."""
    from repro_torch.configs import OptimizerConfig
    return OptimizerConfig(kind="lars", schedule="poly", warmup_epochs=1.0,
                           total_epochs=max(1.0, steps / steps_per_epoch)), \
        0.1


DP_WORKERS = 4  # producer threads of the DP main paths


def dp_setup(torch, cfg, steps: int, lars: bool = False,
             sentinel: bool = False, build=None):
    """Main path 2's pieces (main path 3's with ``lars``; ``build`` adds
    ``build_train_setup`` options: sync-BN, the overlapped sync), through
    the entry points a ``torchrun`` worker calls: (state, train_step,
    data, put_batch, state_shardings, (eval_step, val_data, finalize))."""
    from repro_torch.configs import InputConfig, OptimizerConfig
    from repro_torch.launch.train import build_eval_setup, build_train_setup

    input_cfg = InputConfig(fused=True, num_workers=DP_WORKERS)
    opt_cfg, smoothing = (lars_recipe(steps, steps) if lars
                          else (OptimizerConfig(), 0.0))
    model, state, train_step, data, put_batch, shardings = \
        build_train_setup(
            cfg, global_batch=BATCH, seq_len=0, opt_cfg=opt_cfg,
            steps_per_epoch=steps, dp_mode="shardmap",
            compute_dtype=torch.bfloat16, use_fused_kernel=True,
            compression="bf16+bucketed", fused_bn=True, input_cfg=input_cfg,
            label_smoothing=smoothing, sentinel=sentinel, device="cuda",
            **(build or {}))
    evals = build_eval_setup(model, cfg, global_batch=BATCH, seq_len=0,
                             dp_mode="shardmap", input_cfg=input_cfg)
    return state, train_step, data, put_batch, shardings, evals


def dp_want(calls: int, evals: int, n_leaves: int, lars: bool = False,
            segments: int = 0):
    """Each kernel's launches on the DP main paths for ``calls`` train
    steps and ``evals`` eval batches of ResNet-50's 53 BN sites; the
    overlapped sync (``segments`` > 0) casts each segment's gradients on
    their own."""
    from repro_torch.kernels.fused_update import MAX_LEAVES
    sites = 53
    return {"bn_stats": sites * calls, "bn_bwd_sums": sites * calls,
            "bn_bwd_dx": sites * calls, "bn_apply": (calls + evals) * sites,
            "hybrid_update": 0 if lars else calls * -(-n_leaves
                                                      // MAX_LEAVES),
            "seg_sq_partials": calls if lars else 0,
            "lars_update": calls if lars else 0,
            # one pack (or one a segment) and one unpack per step
            "cast_copy": (max(segments, 1) + 1) * calls,
            "input_train": calls, "input_eval": evals,
            "flash_attention": 0, "rmsnorm": 0}


def dp_cast_entries(calls: int, segments: int = 0):
    """The wire cast's launches per entry point on the DP main paths:
    one ``pack_leaves`` (or a ``cast_copy`` a segment on the overlapped
    sync) and one ``unpack_buckets`` per step."""
    return {"cast_copy": segments * calls,
            "pack_leaves": 0 if segments else calls,
            "unpack_buckets": calls}


def dp_main_path(torch, libs, cfg, steps: int, premade: bool = False,
                 lars: bool = False, build=None, keep_bits: bool = False):
    """Main path 2: the paper's data-parallel step at world size 1 on
    NCCL, with every kernel of the slice on, through the same entry
    points a ``torchrun`` worker calls. ``premade`` feeds it batches
    made before the run (``PremadeSource``). ``lars`` makes it main path
    3: the ``lars_ls_poly`` recipe, whose update runs on the packed
    stream through the stream-LARS kernels. ``build`` adds options
    (main paths 5 and 6: sync-BN, the overlapped sync); ``keep_bits``
    keeps the state's bits after the Trainer's run in ``stats["bits"]``
    (before the profiled step that follows it)."""
    import torch.distributed as dist

    from repro_torch.training import Trainer, TrainerConfig

    workers = DP_WORKERS
    t0 = time.perf_counter()
    state, train_step, data, put_batch, _, (eval_step, val_data, finalize) \
        = dp_setup(torch, cfg, steps, lars=lars, build=build)
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    n_leaves = len(state["params"])
    log(f"  setup {time.perf_counter() - t0:.1f}s: {n_leaves} parameter "
        f"leaves, {sum(p.numel() for p in state['params'].values())} "
        f"elements, backend {dist.get_backend()}, world "
        f"{dist.get_world_size()}")
    p0 = {k: v.clone() for k, v in state["params"].items()}
    source = data
    if premade:
        data = PremadeSource(data, steps)
    tcfg = TrainerConfig(epochs=1, steps_per_epoch=steps,
                         eval_every_epochs=1, val_batches=1, log_every=1,
                         data_workers=workers)
    trainer = Trainer(train_step, state, data, tcfg, eval_step=eval_step,
                      val_data=val_data, finalize_state=finalize,
                      put_batch=put_batch)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts(libs)
    result = trainer.run()
    torch.cuda.synchronize()
    launches = read_counts(libs)
    state = result.state

    losses = [h["loss"] for h in result.history]
    log(f"  losses {losses}")
    assert len(losses) == steps and all(math.isfinite(v) for v in losses), \
        losses
    check_state(torch, state, p0)
    sites, val = len(state["model_state"]), tcfg.val_batches
    assert sites == 53, sites
    segments = (2 + len(cfg.conv_stages)
                if (build or {}).get("overlap_comm") else 0)
    want = dp_want(steps, val, n_leaves, lars, segments)
    from repro_torch.kernels import bucket_ops as bo
    entries = dict(bo.ENTRY_LAUNCHES)
    log(f"  launches {launches} (want {want}), the wire cast's by entry "
        f"{entries}; batches staged {put_batch.staged}")
    assert launches == want, (launches, want)
    assert entries == dp_cast_entries(steps, segments), entries
    bits = None
    if keep_bits:
        bits = train_state_bits(state)
    state, step_kernels = backward_kernel_check(torch, train_step, state,
                                                source, sites)
    ev = result.epoch_history[-1]
    assert math.isfinite(ev["loss"]) and 0.0 <= ev["top1"] <= 1.0, ev
    walls = [h["time"] for h in result.history[1:]]
    waits = [h["data_wait"] for h in result.history[1:]]
    med = statistics.median(walls)
    stats = {"steps": steps, "data_workers": workers,
             "median_step_ms": med * 1e3, "images_per_s": BATCH / med,
             "median_wall_ms": med * 1e3,
             "step_ms": [t * 1e3 for t in walls],
             "data_wait_ms": [t * 1e3 for t in waits],
             "median_data_wait_ms": statistics.median(waits) * 1e3,
             "first_step_ms": result.history[0]["time"] * 1e3,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "kernels_in_a_step": step_kernels,
             "losses": losses,
             "eval": {k: ev[k] for k in ("top1", "loss")}}
    if keep_bits:
        stats["bits"] = bits
    log(f"  median step {stats['median_step_ms']:.2f} ms, "
        f"{stats['images_per_s']:.1f} images/s (bf16, batch {BATCH}; host "
        f"wall time of the whole step, the wait for its batch included); "
        f"median data_wait {stats['median_data_wait_ms']:.2f} ms; peak "
        f"{stats['peak_mem_gib']:.2f} GiB; eval {stats['eval']}")
    return launches, stats, (train_step, state, data)


def dp_reference_phase(torch):
    """Reduced ResNet, f32 on the card, the DP step at world size 1 with
    every new kernel on (fused update, bucketed cast, fused input without
    augmentation) against the same step with them off (plain per-leaf
    update, per-leaf all-reduce, host normalize): three steps from one
    seed. cuDNN is held to deterministic algorithms for the comparison,
    and every kernel is bitwise equal to its plain version, so the two
    must be bitwise equal: losses and every parameter."""
    from repro_torch.configs import (InputConfig, OptimizerConfig,
                                     get_config, reduced_config)
    from repro_torch.launch.train import build_train_setup

    cfg = reduced_config(get_config("resnet50"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for on in (True, False):
            _, state, step, data, put, _ = build_train_setup(
                cfg, global_batch=16, seq_len=0, opt_cfg=OptimizerConfig(),
                steps_per_epoch=4, dp_mode="shardmap",
                compute_dtype=torch.float32, fused_bn=True,
                use_fused_kernel=on,
                compression="bf16+bucketed" if on else "bf16",
                input_cfg=InputConfig(fused=on, augment=False), seed=3,
                device="cuda")
            losses = []
            for i in range(3):
                state, metrics = step(state, put(data.batch_at(i)).take())
                losses.append(float(metrics["loss"]))
            runs[on] = (losses, state["params"])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (lk, pk), (lp, pp) = runs[True], runs[False]
    rel = param_rel_norm(pk, pp)
    bitwise = lk == lp and all(torch.equal(pk[k], pp[k]) for k in pk)
    log(f"  kernels on {lk} vs off {lp}; param rel-norm diff {rel:.3g}; "
        f"bitwise {bitwise}")
    assert all(math.isfinite(v) for v in lk) and bitwise, (lk, lp, rel)
    return {"kernels_on_losses": lk, "kernels_off_losses": lp,
            "param_rel_norm": rel, "bitwise": bitwise}


def lars_reference_phase(torch):
    """Reduced ResNet, f32 on the card, cuDNN held to deterministic
    algorithms: the stream-LARS DP step with error feedback, three steps
    from one seed, twice with the kernels on (which must agree bit for
    bit) and once with the plain stream update. The kernels' segment
    norms are summed in another order than the plain version's, so the
    last two agree to rounding: losses within rtol 1e-5, parameters
    within a relative norm of 1e-5."""
    from repro_torch.configs import InputConfig, get_config, reduced_config
    from repro_torch.launch.train import build_train_setup

    cfg = reduced_config(get_config("resnet50"))
    opt_cfg, smoothing = lars_recipe(3, 4)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for on in (True, True, False):
            _, state, step, data, put, _ = build_train_setup(
                cfg, global_batch=16, seq_len=0, opt_cfg=opt_cfg,
                steps_per_epoch=4, dp_mode="shardmap",
                compute_dtype=torch.float32, fused_bn=True,
                use_fused_kernel=on, compression="bf16+bucketed",
                error_feedback=True, label_smoothing=smoothing,
                input_cfg=InputConfig(fused=True, augment=False), seed=3,
                device="cuda")
            losses = []
            for i in range(3):
                state, metrics = step(state, put(data.batch_at(i)).take())
                losses.append(float(metrics["loss"]))
            runs.append((losses, state))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (l1, s1), (l2, s2), (lp, sp) = runs
    tensors = [(s1["params"], s2["params"]),
               (s1["ef_residual"], s2["ef_residual"]),
               ({"delta": s1["opt"]["delta"]}, {"delta": s2["opt"]["delta"]})]
    repeat = l1 == l2 and all(torch.equal(a[k], b[k]) for a, b in tensors
                              for k in a)
    rel = param_rel_norm(s1["params"], sp["params"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l1, lp))
    log(f"  kernels on {l1} (again: bitwise {repeat}) vs plain {lp}; loss "
        f"rel diff {loss_rel:.3g}, param rel-norm diff {rel:.3g}")
    assert all(math.isfinite(v) for v in l1) and repeat, (l1, l2)
    assert loss_rel <= 1e-5 and rel <= 1e-5, (l1, lp, rel)
    return {"kernels_on_losses": l1, "plain_losses": lp,
            "loss_rel_diff": loss_rel, "param_rel_norm": rel,
            "repeat_bitwise": repeat}


CKPT_STEPS, CKPT_EVERY = 6, 3  # phase 10: six steps, a save every three
# phase 10b: a NaN batch at step 4 (skipped), the newest checkpoint torn
# after the save at step 6, then NaN batches at 7 and 8: two bad steps in
# a row roll back, past the torn step-6 checkpoint, to step 3
SENTINEL_STEPS, SENTINEL_CHAOS = 9, "nan_grad@4,ckpt_truncate@6,nan_grad@7-8"


def state_entries(state):
    """Every tensor of a train state by name (params, ``delta`` and ``m``
    per leaf or the flat stream ``delta``, BN state, the error-feedback
    residual where there is one) and the optimizer's ``step``; the
    state's own tensors, not copies."""
    out = {"opt/step": state["opt"]["step"]}
    for k, t in state.get("ef_residual", {}).items():
        out["ef/" + k] = t
    for k, t in state["params"].items():
        out["params/" + k] = t
    for f, v in state["opt"].items():
        if isinstance(v, dict):
            out.update({f"{f}/{k}": t for k, t in v.items()})
        elif f != "step":
            out[f] = v
    for site, rec in state.get("model_state", {}).items():
        for k, t in rec.items():
            out[f"bn/{site}/{k}"] = t
    return out


def train_state_bits(state):
    """Clones of ``state_entries``: a main-path train state as it stood."""
    return {k: v if k == "opt/step" else v.clone()
            for k, v in state_entries(state).items()}


def bits_differ(torch, a, b):
    """Names of the entries of two ``state_entries`` /
    ``train_state_bits`` that are not bitwise equal (each of ``a``'s
    tensors compared on its counterpart's device)."""
    assert a.keys() == b.keys()
    return [k for k in a if not (a[k] == b[k] if k == "opt/step"
                                 else torch.equal(a[k].to(b[k].device),
                                                  b[k]))]


def dp_trainer(torch, libs, cfg, steps: int, sentinel: bool = False,
               train_step=None, **kw):
    """A ``Trainer`` over ``steps`` steps of main path 2 and one eval
    batch (``kw`` adds checkpointing, resilience or chaos), run with the
    kernel counts set to 0 just before: (result, run wall s, launches,
    state_shardings, the parameter count)."""
    from repro_torch.training import Trainer, TrainerConfig

    ckpt = {k: kw.pop(k) for k in ("checkpoint_dir", "checkpoint_every")
            if k in kw}
    state, step, data, put_batch, shardings, (ev, vd, fin) = dp_setup(
        torch, cfg, steps, sentinel=sentinel)
    tcfg = TrainerConfig(epochs=1, steps_per_epoch=steps,
                         eval_every_epochs=1, val_batches=1, log_every=1,
                         data_workers=DP_WORKERS, **ckpt)
    trainer = Trainer(train_step(step) if train_step else step, state, data,
                      tcfg, eval_step=ev, val_data=vd, finalize_state=fin,
                      put_batch=put_batch, state_shardings=shardings,
                      metadata={"arch": "resnet50",
                                "optimizer": "rmsprop_warmup",
                                "opt_layout": "tree"}, **kw)
    torch.cuda.synchronize()
    reset_counts(libs)
    t0 = time.perf_counter()
    result = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return result, wall, read_counts(libs), shardings, len(state["params"])


def median_step_ms(result) -> float:
    return statistics.median(h["time"] for h in result.history[1:]) * 1e3


def ckpt_phase(torch, libs, cfg):
    """Phase 10: main path 2 with checkpoints, cuDNN held to
    deterministic algorithms. Six steps with a save every three and one
    eval batch (which also writes the best checkpoint); a fresh
    ``Trainer`` then resumes from the step-3 checkpoint alone and runs
    to 6: params, ``delta``, ``m``, BN state and ``opt.step`` bitwise
    equal to the unbroken run. Also six steps with no checkpointing
    (each run's launch counts checked), and the costs of a save and a
    restore of the final state."""
    import shutil
    import tempfile

    from repro_torch import interop
    from repro_torch.checkpoint import (AsyncCheckpointer,
                                        list_checkpoints, restore)
    from repro_torch.checkpoint.checkpointer import ARRAYS, BEST_DIR

    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        unbroken = os.path.join(root, "unbroken")
        runs = {}
        for name, kw in (("no_ckpt", {}),
                         ("ckpt", dict(checkpoint_dir=unbroken,
                                       checkpoint_every=CKPT_EVERY))):
            res, wall, launches, shardings, n_leaves = dp_trainer(
                torch, libs, cfg, CKPT_STEPS, **kw)
            want = dp_want(CKPT_STEPS, 1, n_leaves)
            assert launches == want, (name, launches, want)
            runs[name] = {"median_step_ms": median_step_ms(res),
                          "run_ms_per_step": wall / CKPT_STEPS * 1e3,
                          "step_ms": [h["time"] * 1e3 for h in res.history],
                          "losses": [h["loss"] for h in res.history]}
            if name == "ckpt":
                full = train_state_bits(res.state)
                final = res.state
            else:
                del res
        steps = list_checkpoints(unbroken)
        best = list_checkpoints(os.path.join(unbroken, BEST_DIR))
        assert steps == [CKPT_EVERY, CKPT_STEPS] and best == [CKPT_STEPS], \
            (steps, best)
        first = f"step_{CKPT_EVERY:010d}"
        resumed_dir = os.path.join(root, "resumed")
        shutil.copytree(os.path.join(unbroken, first),
                        os.path.join(resumed_dir, first))
        res, _, launches, _, n_leaves = dp_trainer(
            torch, libs, cfg, CKPT_STEPS, checkpoint_dir=resumed_dir,
            checkpoint_every=CKPT_EVERY)
        want = dp_want(CKPT_STEPS - CKPT_EVERY, 1, n_leaves)
        assert res.resumed_from == CKPT_EVERY, res.resumed_from
        assert launches == want, ("resumed", launches, want)
        differ = bits_differ(torch, full, train_state_bits(res.state))
        log(f"  resumed from step {res.resumed_from}: losses "
            f"{[h['loss'] for h in res.history]} vs unbroken "
            f"{runs['ckpt']['losses'][CKPT_EVERY:]}; {len(full)} entries, "
            f"{len(differ)} not bitwise equal {differ[:5]}")
        assert not differ, differ
        del res
        # the costs of one save (snapshot on the loop's thread, then the
        # background write) and one restore, at the final state
        nbytes = os.path.getsize(os.path.join(unbroken, first, ARRAYS))
        timing = os.path.join(root, "timing")
        ck = AsyncCheckpointer(timing, keep=1)
        snap, write, load = [], [], []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(100 + i, interop.train_state_to_jax(final, shardings))
            t1 = time.perf_counter()
            ck.wait()
            t2 = time.perf_counter()
            arrays, _ = restore(timing)
            interop.train_state_from_jax(arrays, final, shardings)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            snap.append((t1 - t0) * 1e3)
            write.append((t2 - t1) * 1e3)
            load.append((t3 - t2) * 1e3)
        assert not bits_differ(torch, full, train_state_bits(final))
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        shutil.rmtree(root, ignore_errors=True)
    out = {"checkpoint_bytes": nbytes, "entries": len(full),
           "snapshot_ms": snap, "write_ms": write, "restore_ms": load,
           "runs": runs, "resume_bitwise": True}
    log(f"  checkpoint {nbytes} bytes; snapshot (loop thread blocked) "
        f"{statistics.median(snap):.1f} ms, background write "
        f"{statistics.median(write):.1f} ms, restore "
        f"{statistics.median(load):.1f} ms (medians of 3: {snap}, {write}, "
        f"{load})")
    log(f"  median step {runs['ckpt']['median_step_ms']:.2f} ms with a save "
        f"every {CKPT_EVERY} steps vs {runs['no_ckpt']['median_step_ms']:.2f}"
        f" ms without; whole run {runs['ckpt']['run_ms_per_step']:.1f} vs "
        f"{runs['no_ckpt']['run_ms_per_step']:.1f} ms a step (set-up step "
        f"and eval included)")
    return out


def sentinel_phase(torch, libs, cfg):
    """Phase 10b: main path 2 with the sentinel (``--sentinel``), chaos
    ``SENTINEL_CHAOS`` and a save every three steps. Step 4's NaN batch
    is skipped (the state after it bitwise the state after step 3, read
    by a probe around the step); the NaN batches at 7 and 8 roll back,
    past the checkpoint torn after the save at 6, to step 3; the run
    completes, every call's kernels counted. Then six steps with the
    sentinel on and no fault, for its cost beside phase 10's run without
    it, and the device time of its state copy."""
    import json
    import shutil
    import tempfile

    from repro_torch.resilience import ResilienceConfig, parse_chaos
    from repro_torch.resilience.sentinel import _in_place_tensors

    root = tempfile.mkdtemp(prefix="chip_smoke_sentinel_")
    calls, probe = [], {}

    def probed(step):
        def run(state, batch, controls):
            new, metrics = step(state, batch, controls)
            i = len(calls)
            calls.append(bool(metrics["bad_step"]))
            if i in (3, 4):
                probe[i] = train_state_bits(new)
            return new, metrics
        return run

    try:
        log_path = os.path.join(root, "events.jsonl")
        res, _, launches, _, n_leaves = dp_trainer(
            torch, libs, cfg, SENTINEL_STEPS, sentinel=True,
            train_step=probed, checkpoint_dir=os.path.join(root, "ck"),
            checkpoint_every=CKPT_EVERY,
            resilience=ResilienceConfig(max_consecutive_bad=2,
                                        event_log=log_path),
            chaos=parse_chaos(SENTINEL_CHAOS))
        kinds = [r["kind"] for r in res.events]
        with open(log_path) as f:
            on_disk = [json.loads(line)["kind"] for line in f]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  events {kinds}")
    log(f"  bad steps by call {calls}")
    assert on_disk == kinds, (on_disk, kinds)
    skipped = [r["step"] for r in res.events if r["kind"] == "step_skipped"]
    rollbacks = [(r["from_step"], r["to_step"]) for r in res.events
                 if r["kind"] == "rollback"]
    corrupt = [r["step"] for r in res.events
               if r["kind"] == "corrupt_checkpoint_skipped"]
    assert calls[4] and not calls[3], calls
    differ = bits_differ(torch, probe[3], probe[4])
    assert not differ, ("the skipped step changed the state", differ)
    assert skipped == [4, 7, 8] and rollbacks == [(8, CKPT_EVERY)] \
        and corrupt == [6], (skipped, rollbacks, corrupt)
    # 9 steps, then steps 3..8 again after the rollback
    assert len(calls) == SENTINEL_STEPS + SENTINEL_STEPS - CKPT_EVERY, calls
    want = dp_want(len(calls), 1, n_leaves)
    assert launches == want, (launches, want)
    losses = [h["loss"] for h in res.history]
    assert res.history[-1]["step"] == SENTINEL_STEPS - 1 and all(
        math.isfinite(v) for v in losses), res.history
    state = res.state
    del res
    # the sentinel's own cost: its copy of the in-place state, timed on
    # the device, and six steps with the sentinel on and no fault
    live = _in_place_tensors(state)
    backup = [torch.empty_like(t) for t in live]
    copy_ms = time_eager_ms(torch,
                            lambda: torch._foreach_copy_(backup, live))
    copy_bytes = 2 * sum(t.numel() * t.element_size() for t in live)
    del state, live, backup
    res, wall, launches, _, n_leaves = dp_trainer(
        torch, libs, cfg, CKPT_STEPS, sentinel=True,
        resilience=ResilienceConfig())
    assert launches == dp_want(CKPT_STEPS, 1, n_leaves), launches
    out = {"events": kinds, "bad_by_call": calls, "skip_bitwise": True,
           "rollbacks": rollbacks, "corrupt_skipped": corrupt,
           "losses": losses, "copy_ms": copy_ms, "copy_bytes": copy_bytes,
           "copy_bound_ms": copy_bytes / HBM_BYTES_PER_S * 1e3,
           "sentinel_median_step_ms": median_step_ms(res),
           "sentinel_run_ms_per_step": wall / CKPT_STEPS * 1e3}
    log(f"  sentinel copy of the in-place state {copy_ms:.3f} ms on the "
        f"device ({copy_bytes} bytes moved, bound "
        f"{out['copy_bound_ms']:.3f} ms); median step with the sentinel on "
        f"{out['sentinel_median_step_ms']:.2f} ms, whole run "
        f"{out['sentinel_run_ms_per_step']:.1f} ms a step")
    return out


# main path 6: the overlapped step's buckets. ResNet-50's 51 MB bf16
# gradient stream is one bucket at path 2's 64 MiB, which only the stem
# segment's backward can close; at 16 MiB it is four, the first closed by
# the stage-3 segment's backward
OVERLAP_BUCKET_MIB = 16
# all-reduces a sync-BN site adds to a train step: the mean and the
# variance in the forward, S1 and S2 stacked in the backward
SYNC_CALLS_PER_SITE = 3


def allreduce_check(torch, train_step, state, data):
    """One more DP step under torch.profiler with ``dist.all_reduce``
    counted by a wrapper (the async bucket launches inside a
    ``record_function`` span). Returns (new state, record): the calls by
    kind, the profiler's all-reduce ops and NCCL kernels, and where they
    exist whether the first bucket launch on the host comes before the
    last BN backward (``_TrainFnBackward``) begins, and whether the first
    NCCL kernel starts before the last ``dx_kernel`` ends."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    real = dist.all_reduce
    calls = {"blocking": 0, "async": 0}

    def counted(t, *a, **kw):
        if kw.get("async_op"):
            calls["async"] += 1
            with record_function("bucket_all_reduce"):
                return real(t, *a, **kw)
        calls["blocking"] += 1
        return real(t, *a, **kw)

    batch = data.batch_at(3000)
    torch.cuda.synchronize()
    dist.all_reduce = counted
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, metrics = train_step(state, batch)
            float(metrics["loss"])
            torch.cuda.synchronize()
    finally:
        dist.all_reduce = real
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    kern = [e for e in events if e.device_type == DeviceType.CUDA]

    def first_start(evs):
        return min((e.time_range.start for e in evs), default=None)

    def last(evs, attr):
        return max((getattr(e.time_range, attr) for e in evs), default=None)

    ops = [e for e in host if e.name == "c10d::allreduce_"]
    buckets = [e for e in host if e.name == "bucket_all_reduce"]
    bn_bwd = [e for e in host if e.name == "_TrainFnBackward"]
    nccl = [e for e in kern if "nccl" in e.name.lower()]
    dx = [e for e in kern if "dx_kernel" in e.name]
    rec = {"calls": calls["blocking"] + calls["async"], **calls,
           "c10d_allreduce_ops": len(ops),
           # the host time inside the all-reduce calls, children included
           "allreduce_host_ms": sum(e.cpu_time_total for e in ops) / 1e3,
           "nccl_all_reduce_ops": sum(e.name == "nccl:all_reduce"
                                      for e in host),
           "nccl_kernels": len(nccl),
           "first_bucket_before_last_bn_backward_host": None,
           "first_nccl_kernel_before_last_dx_end": None}
    if buckets and bn_bwd:
        rec["first_bucket_before_last_bn_backward_host"] = \
            first_start(buckets) < last(bn_bwd, "start")
    if nccl and dx:
        rec["first_nccl_kernel_before_last_dx_end"] = \
            first_start(nccl) < last(dx, "end")
    log(f"  one more step under torch.profiler: all-reduces {rec}")
    return state, rec


def sync_bn_phase(torch, libs, cfg):
    """Phase 11: main path 5, main path 2 with ``sync_bn=True``, beside
    main path 2 itself, cuDNN held to deterministic algorithms. At world
    size 1 every all-reduce is a sum of one and each site's mean -
    global mean is exactly 0, so the launches are path 2's and the state
    after the steps is bitwise path 2's; one more step of each counts
    the all-reduces (3 a BN site more). Returns (record, path 2's
    bits, for phase 12)."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    runs = {}
    try:
        for name, build in (("path2", {}), ("path5", {"sync_bn": True})):
            launches, stats, live = dp_main_path(torch, libs, cfg, STEPS,
                                                 build=build,
                                                 keep_bits=True)
            _, stats["allreduce"] = allreduce_check(torch, *live)
            runs[name] = (launches, stats)
            del live
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    (l2, s2), (l5, s5) = runs["path2"], runs["path5"]
    assert l5 == l2, (l5, l2)
    bits2 = s2.pop("bits")
    differ = bits_differ(torch, bits2, s5.pop("bits"))
    extra = s5["allreduce"]["calls"] - s2["allreduce"]["calls"]
    sites = 53
    log(f"  path 5 vs path 2: {len(bits2)} entries, {len(differ)} not "
        f"bitwise equal {differ[:5]}; losses {s5['losses']} vs "
        f"{s2['losses']}")
    log(f"  median step {s5['median_step_ms']:.2f} ms (sync-BN) vs "
        f"{s2['median_step_ms']:.2f} ms (path 2), same run, cuDNN "
        f"deterministic; all-reduces a step {s5['allreduce']['calls']} vs "
        f"{s2['allreduce']['calls']}: {extra} for {sites} sites")
    assert not differ, differ
    assert extra == SYNC_CALLS_PER_SITE * sites, extra
    return {"path2": s2, "path5": s5, "path5_launches": l5,
            "bitwise": True, "sync_allreduces_per_step": extra}, bits2


def sync_bn_cards_worker(rank: int, out_dir: str) -> None:
    """One of phase 11b's two workers, both on the one card, joined over
    gloo: three sync-BN DP steps of the reduced ResNet in f32 on the card
    (kernels), then the same on the CPU (plain versions)."""
    sys.path.insert(0, SRC)
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import (InputConfig, OptimizerConfig,
                                     get_config, reduced_config)
    from repro_torch.kernels import fused_bn as fb
    from repro_torch.launch.train import build_train_setup

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=2)
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            fb.reset_launch_counts()
            _, state, step, data, put, _ = build_train_setup(
                reduced_config(get_config("resnet50")), global_batch=16,
                seq_len=0, opt_cfg=OptimizerConfig(), steps_per_epoch=4,
                dp_mode="shardmap", compute_dtype=torch.float32,
                use_fused_kernel=True, compression="bf16+bucketed",
                fused_bn=True, sync_bn=True,
                input_cfg=InputConfig(fused=True, augment=False), seed=3,
                device=dev)
            for i in range(3):
                batch = put(data.batch_at(i))
                state, metrics = step(state, batch.take()
                                      if hasattr(batch, "take") else batch)
                out[f"{dev}/loss{i}"] = np.float64(metrics["loss"])
            for k, v in state["params"].items():
                out[f"{dev}/p/{k}"] = v.detach().cpu().numpy()
            out[f"{dev}/bn_bwd_dx"] = np.int64(fb.LAUNCHES["bn_bwd_dx"])
            out[f"{dev}/sites"] = np.int64(len(state["model_state"]))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def sync_bn_cards_phase(torch):
    """Phase 11b: the cross-worker sums on the card. Two processes share
    the card over gloo (a ``file://`` store; NCCL refuses two ranks on
    one device): the reduced ResNet in f32 with fused BN and sync-BN,
    three steps, on the card against the same two workers on the CPU:
    losses within rtol 2e-5, parameters within a relative norm of 2e-4
    (ROADMAP's DP tolerances), the two workers' parameters bitwise equal
    on each device, and ``bn_bwd_dx`` launched at every site of every
    step on the card with the count 2 x rows."""
    import shutil
    import tempfile

    import numpy as np

    root = tempfile.mkdtemp(prefix="chip_smoke_sync_")
    try:
        spawn(sync_bn_cards_worker, args=(root,), nprocs=2)
        ranks = [dict(np.load(os.path.join(root, f"rank{r}.npz")))
                 for r in (0, 1)]
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def params(d, dev):
        pre = f"{dev}/p/"
        return {k[len(pre):]: torch.from_numpy(v) for k, v in d.items()
                if k.startswith(pre)}

    losses = {dev: [float(ranks[0][f"{dev}/loss{i}"]) for i in range(3)]
              for dev in ("cuda", "cpu")}
    rel = param_rel_norm(params(ranks[0], "cuda"), params(ranks[0], "cpu"))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                       losses["cpu"]))
    same = all(torch.equal(v, params(ranks[1], dev)[k])
               for dev in ("cuda", "cpu")
               for k, v in params(ranks[0], dev).items())
    dx = [int(r["cuda/bn_bwd_dx"]) for r in ranks]
    sites = int(ranks[0]["cuda/sites"])
    log(f"  card {losses['cuda']} vs CPU {losses['cpu']}: loss rel diff "
        f"{loss_rel:.3g}, param rel-norm diff {rel:.3g}; workers' params "
        f"bitwise equal {same}; bn_bwd_dx launches per worker {dx} "
        f"({sites} sites x 3 steps)")
    assert all(math.isfinite(v) for v in losses["cuda"]), losses
    assert loss_rel <= 2e-5 and rel < 2e-4, (losses, rel)
    assert same and dx == [3 * sites] * 2, (same, dx)
    return {"card_losses": losses["cuda"], "cpu_losses": losses["cpu"],
            "loss_rel_diff": loss_rel, "param_rel_norm": rel,
            "bn_bwd_dx_launches": dx}


def overlap_phase(torch, libs, cfg, bits2, path2_ms: float):
    """Phase 12: main path 6, main paths 2 and 3 with ``overlap_comm=True``
    (buckets of ``OVERLAP_BUCKET_MIB``), cuDNN held to deterministic
    algorithms, the wire cast launched once a segment (``cast_copy``) and
    once for the unpack (``unpack_buckets``). Path 2 overlapped must be bitwise path 2 (phase 11's run,
    same seed), and path 3 overlapped bitwise path 3 (both run here):
    losses, parameters, the optimizer state (path 3's flat ``delta``:
    the overlapped step puts the synced stream back in the bucketed
    step's leaf order before the update) and the BN state."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    build = {"overlap_comm": True, "bucket_bytes": OVERLAP_BUCKET_MIB << 20}
    try:
        l6, s6, live = dp_main_path(torch, libs, cfg, STEPS, build=build,
                                    keep_bits=True)
        _, s6["allreduce"] = allreduce_check(torch, *live)
        del live
        differ = bits_differ(torch, bits2, s6.pop("bits"))
        log(f"  path 2 overlapped vs path 2: {len(differ)} of {len(bits2)} "
            f"entries not bitwise equal {differ[:5]}; median step "
            f"{s6['median_step_ms']:.2f} ms vs {path2_ms:.2f} ms (phase 11,"
            f" same run)")
        assert not differ, differ
        runs = {}
        for name, b in (("path3", None), ("path3_overlap", build)):
            launches, st, live = dp_main_path(torch, libs, cfg, STEPS,
                                              lars=True, build=b,
                                              keep_bits=True)
            del live
            runs[name] = (launches, st)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    (_, s3), (l6b, s6b) = runs["path3"], runs["path3_overlap"]
    b3, b6b = s3.pop("bits"), s6b.pop("bits")
    differ3 = bits_differ(torch, b3, b6b)
    log(f"  path 3 overlapped vs path 3: losses {s6b['losses']} vs "
        f"{s3['losses']}; {len(differ3)} of {len(b3)} entries not bitwise "
        f"equal {differ3[:5]}; median step {s6b['median_step_ms']:.2f} ms "
        f"vs {s3['median_step_ms']:.2f} ms")
    assert s6b["losses"] == s3["losses"] and not differ3, differ3[:5]
    return {"path6": s6, "path6_launches": l6, "bitwise_vs_path2": True,
            "path3": s3, "path3_overlap": s6b, "path3_overlap_launches": l6b,
            "path3_bitwise": True, "bucket_mib": OVERLAP_BUCKET_MIB}


def overlap_reference_phase(torch):
    """Phase 12b: the reduced ResNet in f32 on the card, cuDNN held to
    deterministic algorithms: the overlapped step with error feedback
    and every kernel on (fused update, ready-order buckets cast per
    segment, fused input) against the per-leaf error-feedback step with
    them off (plain update, per-leaf all-reduce, host normalize), three
    steps from one seed: bitwise (6b's tolerance), losses, parameters
    and the residual. Then stream-LARS with error feedback, overlapped
    against bucketed, kernels on in both: bitwise, losses, parameters,
    ``delta`` and the residual."""
    from repro_torch.configs import (InputConfig, OptimizerConfig,
                                     get_config, reduced_config)
    from repro_torch.launch.train import build_train_setup

    cfg = reduced_config(get_config("resnet50"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for on in (True, False):
            _, state, step, data, put, _ = build_train_setup(
                cfg, global_batch=16, seq_len=0, opt_cfg=OptimizerConfig(),
                steps_per_epoch=4, dp_mode="shardmap",
                compute_dtype=torch.float32, fused_bn=True,
                use_fused_kernel=on,
                compression="bf16+bucketed" if on else "bf16",
                overlap_comm=on, bucket_bytes=16384, error_feedback=True,
                input_cfg=InputConfig(fused=on, augment=False), seed=3,
                device="cuda")
            losses = []
            for i in range(3):
                state, metrics = step(state, put(data.batch_at(i)).take())
                losses.append(float(metrics["loss"]))
            runs[on] = (losses, state)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (lk, sk), (lp, sp) = runs[True], runs[False]
    rel = param_rel_norm(sk["params"], sp["params"])
    bitwise = lk == lp and all(
        torch.equal(sk[f][k], sp[f][k]) for f in ("params", "ef_residual")
        for k in sk[f])
    nz = max(float(v.abs().max()) for v in sk["ef_residual"].values())
    log(f"  overlapped, kernels on {lk} vs per-leaf, off {lp}; param "
        f"rel-norm diff {rel:.3g}; bitwise {bitwise}; residual max {nz:.3g}")
    assert all(math.isfinite(v) for v in lk) and bitwise and nz > 0, \
        (lk, lp, rel)
    opt_cfg, smoothing = lars_recipe(3, 4)
    lars = {}
    torch.backends.cudnn.deterministic = True
    try:
        for overlap in (True, False):
            _, state, step, data, put, _ = build_train_setup(
                cfg, global_batch=16, seq_len=0, opt_cfg=opt_cfg,
                steps_per_epoch=4, dp_mode="shardmap",
                compute_dtype=torch.float32, fused_bn=True,
                use_fused_kernel=True, compression="bf16+bucketed",
                overlap_comm=overlap, bucket_bytes=16384,
                error_feedback=True, label_smoothing=smoothing,
                input_cfg=InputConfig(fused=True, augment=False), seed=3,
                device="cuda")
            losses = []
            for i in range(3):
                state, metrics = step(state, put(data.batch_at(i)).take())
                losses.append(float(metrics["loss"]))
            bits = train_state_bits(state)
            bits.update({"ef/" + k: v.clone()
                         for k, v in state["ef_residual"].items()})
            lars[overlap] = (losses, bits)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (lo, bo), (lb, bb) = lars[True], lars[False]
    lars_differ = bits_differ(torch, bb, bo)
    log(f"  stream-LARS overlapped {lo} vs bucketed {lb}: "
        f"{len(lars_differ)} of {len(bb)} entries not bitwise equal "
        f"{lars_differ[:5]}")
    assert lo == lb and not lars_differ, (lo, lb, lars_differ[:5])
    return {"kernels_on_losses": lk, "kernels_off_losses": lp,
            "param_rel_norm": rel, "bitwise": bitwise,
            "lars_overlap_losses": lo, "lars_bucketed_losses": lb,
            "lars_bitwise": True}


ZERO_WORKERS = 2  # main path 7: two processes share the one card
ZERO_CKPT_STEPS, ZERO_CKPT_EVERY = 4, 2  # cut from 6, 3 for phase 28's time
ZERO_SMALL_BUCKET = 16384  # 13b: several ready-order buckets (as 12b)
# bytes an element of the hybrid update with the decay stream: g, p, d,
# m and wd read, p, d and m written, f32
ZERO_UPDATE_BYTES = 32


def as_zero_shard(torch, field, params, plan, n: int, w: int):
    """A run's optimizer field in ZeRO's layout: a per-leaf dict, or a
    flat leaf-order stream, packed into the stream of ``plan`` (+ the
    zero pad), and worker ``w``'s block of its shard layout
    (``local_shard``, which the tests hold to the block of
    ``stream_to_shard_layout``; it builds no index of the whole
    stream)."""
    from repro_torch.distributed.bucketing import leaf_order, local_shard
    from repro_torch.models.common import slice_views
    if isinstance(field, dict):
        leaves = field
    else:
        leaves, off = {}, 0
        for k in leaf_order(params):
            leaves[k] = field[off:off + params[k].numel()]
            off += params[k].numel()
    # an LM's overlapped plan names leading-dim slices of its leaves
    leaves = slice_views(leaves, plan.names)
    pad = torch.zeros(plan.pad_elems,
                      device=next(iter(params.values())).device)
    stream = torch.cat([leaves[k].reshape(-1).float() for k in plan.names]
                       + [pad])
    return local_shard(stream, plan, n, w).clone()


def zero_bits(torch, state, plan, n: int, w: int):
    """``train_state_bits`` with each flat optimizer field as worker
    ``w``'s ZeRO shard (a ZeRO run's own; another run's converted by
    ``as_zero_shard``)."""
    from repro_torch.distributed.bucketing import shard_size
    out = train_state_bits({**state, "opt": {"step": state["opt"]["step"]}})
    for f, v in state["opt"].items():
        if f == "step":
            continue
        mine = torch.is_tensor(v) and v.numel() == shard_size(plan, n)
        out["opt/" + f] = (v.float().clone() if mine else
                           as_zero_shard(torch, v, state["params"], plan, n,
                                         w))
    return out


def zero_differ(torch, a, b):
    """``bits_differ`` over the entries two runs share; a ZeRO
    ``momentum_sgd`` run's ``m`` (zeros) has no per-leaf counterpart."""
    a = dict(a)
    if "opt/m" in a and "opt/m" not in b:
        assert not bool(a.pop("opt/m").any())
    return bits_differ(torch, a, b)


def zero_setup(torch, cfg, steps: int, zero: bool,
               workers: int = ZERO_WORKERS, **build):
    """Main path 7's pieces (``zero`` False: main path 2's configuration
    at 2 workers) for one of the two workers: 32 images a worker.
    ``workers`` and ``build`` (``build_train_setup`` options) give main
    path 8's at 4 workers."""
    from repro_torch.configs import InputConfig, OptimizerConfig
    from repro_torch.launch.train import build_eval_setup, build_train_setup

    input_cfg = InputConfig(fused=True, num_workers=DP_WORKERS // 2)
    model, state, step, data, put, shardings = build_train_setup(
        cfg, global_batch=BATCH * workers, seq_len=0,
        opt_cfg=OptimizerConfig(), steps_per_epoch=steps,
        dp_mode="shardmap", compute_dtype=torch.bfloat16,
        use_fused_kernel=True, compression="bf16+bucketed", fused_bn=True,
        input_cfg=input_cfg, zero_dp=zero, device="cuda", **build)
    evals = build_eval_setup(model, cfg, global_batch=BATCH * workers,
                             seq_len=0, dp_mode="shardmap",
                             input_cfg=input_cfg)
    return state, step, data, put, shardings, evals


def zero_trainer(torch, libs, cfg, steps: int, zero: bool,
                 workers: int = ZERO_WORKERS, build=None, **tkw):
    """A ``Trainer`` over ``steps`` steps and one eval batch, the launch
    counts set to 0 just before it and read just after: (result, state
    shardings, train step, data, put_batch, launches, entry launches of
    ``fused_update``, peak GiB)."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.training import Trainer, TrainerConfig

    ckpt = {k: tkw.pop(k) for k in ("checkpoint_dir", "checkpoint_every")
            if k in tkw}
    state, step, data, put, sh, (ev, vd, fin) = zero_setup(
        torch, cfg, steps, zero, workers, **(build or {}))
    tcfg = TrainerConfig(epochs=1, steps_per_epoch=steps,
                         eval_every_epochs=1, val_batches=1, log_every=1,
                         data_workers=DP_WORKERS // 2, **ckpt)
    trainer = Trainer(step, state, data, tcfg, eval_step=ev, val_data=vd,
                      finalize_state=fin, put_batch=put, state_shardings=sh,
                      metadata={"arch": "resnet50",
                                "optimizer": "rmsprop_warmup",
                                "opt_layout": "zero_stream" if zero
                                else "tree"})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(libs)
    res = trainer.run()
    torch.cuda.synchronize()
    return (res, sh, step, data, put, read_counts(libs),
            dict(fu.ENTRY_LAUNCHES), torch.cuda.max_memory_allocated() / 2 ** 30)


def collective_check(torch, train_step, state, data):
    """One more step with ``reduce_scatter_tensor``,
    ``all_gather_into_tensor`` and ``all_reduce`` counted (calls and
    elements)."""
    import torch.distributed as dist
    names = ("reduce_scatter_tensor", "all_gather_into_tensor", "all_reduce")
    real = {k: getattr(dist, k) for k in names}
    calls = {k: [] for k in names}

    def counted(name):
        def call(*a, **kw):
            t = a[1] if name != "all_reduce" else a[0]
            calls[name].append(t.numel())
            return real[name](*a, **kw)
        return call

    for k in names:
        setattr(dist, k, counted(k))
    try:
        state, metrics = train_step(state, data.batch_at(3000))
        float(metrics["loss"])
        torch.cuda.synchronize()
    finally:
        for k in names:
            setattr(dist, k, real[k])
    return state, calls


def param_digest(state) -> str:
    import hashlib
    h = hashlib.sha256()
    for k in sorted(state["params"]):
        h.update(state["params"][k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def zero_path7(torch, libs, rank: int):
    """Phase 13 in one worker: main path 7 (ZeRO) and then main path 2's
    configuration at 2 workers from the same seed, through the
    ``Trainer``; the first run's launches and collectives."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.bucketing import shard_size

    cfg = get_config("resnet50")
    runs = {}
    for zero in (True, False):
        res, sh, step, data, put, launches, entries, peak = zero_trainer(
            torch, libs, cfg, STEPS, zero)
        state = res.state
        if zero:
            plan = sh.zero_plan
        bits = zero_bits(torch, state, plan, ZERO_WORKERS, rank)
        opt_bytes = sum(
            t.numel() * t.element_size() for v in state["opt"].values()
            for t in (v.values() if isinstance(v, dict) else
                      [v] if torch.is_tensor(v) else []))
        walls = [h["time"] * 1e3 for h in res.history[1:]]
        rec = {"losses": [h["loss"] for h in res.history],
               "step_ms": walls, "median_step_ms": statistics.median(walls),
               "peak_gib": peak, "opt_state_bytes": opt_bytes,
               "launches": launches, "entry_launches": entries,
               "eval": {k: res.epoch_history[-1][k] for k in ("top1", "loss")},
               "digest": param_digest(state)}
        if zero:
            state, calls = collective_check(torch, step, state, data)
            rec["collectives_a_step"] = {k: len(v) for k, v in calls.items()}
            rec["collective_elements"] = calls
            rec["n_buckets"] = plan.n_buckets
            rec["shard_elements"] = shard_size(plan, ZERO_WORKERS)
            rec["plan"] = plan.describe()
        runs[zero] = (rec, bits)
        del res, state, step, data, put
    (zrec, zbits), (brec, bbits) = runs[True], runs[False]
    differ = zero_differ(torch, zbits, bbits)
    return {"zero": zrec, "bucketed": brec, "entries": len(zbits),
            "differ": differ[:10], "n_differ": len(differ)}


def zero_ckpt(torch, libs, rank: int, root: str):
    """Phase 13's checkpoints: ZeRO with a save every 2 of 4 steps, a
    fresh ``Trainer`` resumed from the step-2 checkpoint alone (bitwise
    the unbroken run), and the step-2 ZeRO checkpoint restored into main
    path 2's configuration through ``make_zero_restore_transform``,
    which then runs steps 2-3 (bitwise the unbroken ZeRO run)."""
    import shutil

    import torch.distributed as dist

    from repro_torch import interop
    from repro_torch.checkpoint import list_checkpoints, restore
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.optim import stream as tstream

    cfg = get_config("resnet50")
    unbroken = os.path.join(root, "unbroken")
    resumed = os.path.join(root, "resumed")
    res, sh, *_ = zero_trainer(torch, libs, cfg, ZERO_CKPT_STEPS, True,
                               checkpoint_dir=unbroken,
                               checkpoint_every=ZERO_CKPT_EVERY)
    plan = sh.zero_plan
    full = zero_bits(torch, res.state, plan, ZERO_WORKERS, rank)
    unbroken_losses = [h["loss"] for h in res.history]
    del res
    first = f"step_{ZERO_CKPT_EVERY:010d}"
    if rank == 0:
        assert list_checkpoints(unbroken) == [ZERO_CKPT_EVERY,
                                              ZERO_CKPT_STEPS]
        shutil.copytree(os.path.join(unbroken, first),
                        os.path.join(resumed, first))
    dist.barrier()
    res, _, _, _, _, launches, _, _ = zero_trainer(
        torch, libs, cfg, ZERO_CKPT_STEPS, True, checkpoint_dir=resumed,
        checkpoint_every=ZERO_CKPT_EVERY)
    resumed_from = res.resumed_from
    differ = zero_differ(torch, zero_bits(torch, res.state, plan,
                                          ZERO_WORKERS, rank), full)
    del res
    # the ZeRO checkpoint in main path 2's configuration (per-leaf state)
    state, step, data, put, bsh, _ = zero_setup(torch, cfg,
                                                ZERO_CKPT_STEPS, False)
    hook = tstream.make_zero_restore_transform(
        plan, tstream.param_key_tree(state["params"]), ZERO_WORKERS,
        to_zero=False, fields=tstream.make_stream_optimizer(
            OptimizerConfig(), 1, 1).state_fields)
    arrays, manifest = restore(unbroken, step=ZERO_CKPT_EVERY, transform=hook)
    interop.train_state_from_jax(arrays, state, bsh)
    losses = []
    for i in range(ZERO_CKPT_EVERY, ZERO_CKPT_STEPS):
        state, met = step(state, put(data.batch_at(i)).take())
        losses.append(float(met["loss"]))
    to_tree = zero_differ(torch, full, zero_bits(torch, state, plan,
                                                 ZERO_WORKERS, rank))
    return {"resumed_from": resumed_from, "resume_differ": differ[:10],
            "entries": len(full), "unbroken_losses": unbroken_losses,
            "to_tree_losses": losses, "to_tree_differ": to_tree[:10],
            "to_tree_unbroken_losses": unbroken_losses[ZERO_CKPT_EVERY:],
            "opt_layout": manifest["metadata"]["opt_layout"],
            "resumed_launches": launches}


ZERO_PAIRS = {  # phase 13b: (build options, bitwise)
    "overlap_ef": (dict(overlap_comm=True, error_feedback=True,
                        bucket_bytes=ZERO_SMALL_BUCKET), True),
    "lars": (dict(lars=True), True),
    "momentum": (dict(opt="momentum_sgd"), True),
    "lars_overlap": (dict(lars=True, overlap_comm=True,
                          bucket_bytes=ZERO_SMALL_BUCKET), False),
}
ZERO_PAIR_TOL = dict(rtol=1e-2, atol=1e-4)


def zero_reduced_pairs(torch, libs, rank: int):
    """Phase 13b in one worker: the reduced ResNet in f32, every kernel
    on, three steps of each pair from one seed."""
    from repro_torch.configs import (InputConfig, OptimizerConfig,
                                     get_config, reduced_config)
    from repro_torch.kernels import fused_update as fu
    from repro_torch.launch.train import build_train_setup

    cfg = reduced_config(get_config("resnet50"))
    out = {}
    for name, (kw, bitwise) in ZERO_PAIRS.items():
        kw = dict(kw)
        opt_cfg, smoothing = (lars_recipe(3, 4) if kw.pop("lars", False)
                              else (OptimizerConfig(kind=kw.pop(
                                  "opt", "rmsprop_warmup")), 0.0))
        runs = {}
        for zero in (True, False):
            _, state, step, data, put, sh = build_train_setup(
                cfg, global_batch=16, seq_len=0, opt_cfg=opt_cfg,
                steps_per_epoch=4, dp_mode="shardmap",
                compute_dtype=torch.float32, fused_bn=True,
                use_fused_kernel=True, compression="bf16+bucketed",
                label_smoothing=smoothing, zero_dp=zero,
                input_cfg=InputConfig(fused=True, augment=False), seed=3,
                device="cuda", **kw)
            plan = sh.zero_plan if zero else plan
            reset_counts(libs)
            losses = []
            for i in range(3):
                state, metrics = step(state, put(data.batch_at(i)).take())
                losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            runs[zero] = (losses, zero_bits(torch, state, plan, ZERO_WORKERS,
                                            rank), read_counts(libs),
                          dict(fu.ENTRY_LAUNCHES))
        (lz, bz, cz, ez), (lb, bb, _, _) = runs[True], runs[False]
        rec = {"zero_losses": lz, "losses": lb, "launches": cz,
               "entry_launches": ez, "entries": len(bz)}
        if bitwise:
            differ = zero_differ(torch, bz, bb)
            rec.update(differ=differ[:10], n_differ=len(differ),
                       bitwise=lz == lb and not differ)
        else:
            worst = {}
            for k, v in bz.items():
                if k in bb and k.startswith(("params/", "opt/")) \
                        and k != "opt/step":
                    ref = bb[k].double()
                    excess = ((v.double() - ref).abs()
                              - ZERO_PAIR_TOL["atol"]
                              - ZERO_PAIR_TOL["rtol"] * ref.abs())
                    worst[k] = float(excess.max())
            rec.update(max_excess=max(worst.values()),
                       worst=max(worst, key=worst.get),
                       loss_rel=max(abs(a - b) / abs(b)
                                    for a, b in zip(lz, lb)),
                       differ_bitwise=sum(not torch.equal(bz[k], bb[k])
                                          for k in worst))
        out[name] = rec
    return out


def zero_cards_worker(rank: int, out_dir: str) -> None:
    """One of phase 13's two workers, both on the one card, joined over
    gloo: main path 7 against main path 2's configuration, ZeRO's
    checkpoints (13), and the reduced pairs (13b), cuDNN deterministic.
    Writes ``rank{rank}.json``."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import bucket_ops as bo
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_bn as fb
    from repro_torch.kernels import fused_input as fi
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import rmsnorm as rn
    libs = (fb, fu, bo, fi, fa, rn)

    torch.cuda.set_device(0)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=ZERO_WORKERS)
    try:
        t0 = time.perf_counter()
        out = {"path7": zero_path7(torch, libs, rank)}
        out["path7_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["ckpt"] = zero_ckpt(torch, libs, rank,
                                os.path.join(out_dir, "ckpt"))
        out["ckpt_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["reduced"] = zero_reduced_pairs(torch, libs, rank)
        out["reduced_s"] = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def zero_update_timing(torch, n: int):
    """``hybrid_update`` through the decay-stream entry at a ZeRO worker's
    shard of ``n`` elements (decay 0 on a third, in runs), against its
    plain version: bitwise, the kernel's and plain version's device ms
    and the bytes bound."""
    from repro_torch.core.optimizer import HybridHyper
    from repro_torch.kernels import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(7)
    g = torch.randn(n, device="cuda", generator=gen) * 1e-2
    p = torch.randn(n, device="cuda", generator=gen)
    d = torch.randn(n, device="cuda", generator=gen) * 1e-3
    m = torch.rand(n, device="cuda", generator=gen) * 1e-4
    runs = (torch.rand(n // 512 + 1, device="cuda", generator=gen)
            < 1 / 3).repeat_interleave(512)[:n]
    wd = torch.where(runs, 0.0, 5e-5)
    h = HybridHyper(eta=0.05, alpha_sgd=0.5)
    kern = [t.clone() for t in (p, d, m)]
    plain = [t.clone() for t in (p, d, m)]
    fu.fused_hybrid_update(g, *kern, h, wd)
    fu.PLAIN["hybrid_update"](g, *plain, h, wd)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(kern, plain))
    ms = time_ms(torch, lambda: fu.fused_hybrid_update(g, *kern, h, wd))
    plain_ms = time_ms(torch, lambda: fu.PLAIN["hybrid_update"](
        g, *plain, h, wd))
    nbytes = ZERO_UPDATE_BYTES * n
    ms_bound, by = bound(nbytes, UPDATE_FLOPS * n)
    return {"elements": n, "bitwise": bitwise, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": ms_bound, "bound_by": by,
            "bytes": nbytes}


def zero_phase(torch):
    """Phases 13 and 13b: two processes share the card over gloo (NCCL
    refuses two ranks on one device). 13, main path 7: ResNet-50 at full
    width, 32 images a worker (64 in all), bf16, fused BN, update and
    input, ``bf16+bucketed`` (64 MiB), rmsprop_warmup + slow_start, ZeRO:
    8 steps and one eval batch through the ``Trainer``, bitwise main path
    2's configuration at 2 workers from the same seed (losses,
    parameters, BN state, ``opt.step``, ``delta`` / ``m`` as this
    worker's shard); launches a step as path 2's, ``hybrid_update``
    through its decay-stream entry; one reduce-scatter and one all-gather
    a bucket and one all-reduce (the metrics) a step; a save every 2 of
    4 steps resumed from step 2 alone and the step-2 checkpoint carried
    into main path 2's per-leaf state, both bitwise the unbroken run.
    13b: the reduced ResNet in f32, every kernel on: ZeRO + overlap
    against overlap, ZeRO stream-LARS and ``momentum_sgd`` against their
    bucketed steps (bitwise), ZeRO + overlap stream-LARS against
    overlapped stream-LARS (rtol 1e-2 / atol 1e-4). Then, in this
    process, ``hybrid_update`` at the worker's shard shape, timed.
    Returns (record, rank 0's launches on main path 7)."""
    import shutil
    import tempfile


    root = tempfile.mkdtemp(prefix="chip_smoke_zero_")
    try:
        spawn(zero_cards_worker, args=(root,), nprocs=ZERO_WORKERS)
        ranks = []
        for r in range(ZERO_WORKERS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    from repro_torch.kernels.fused_update import MAX_LEAVES
    n_leaves = 161
    for r, rec in enumerate(ranks):
        p7, z = rec["path7"], rec["path7"]["zero"]
        b = p7["bucketed"]
        log(f"  worker {r}: ZeRO losses {z['losses']} vs bucketed "
            f"{b['losses']}; {p7['n_differ']} of {p7['entries']} entries "
            f"not bitwise equal {p7['differ'][:5]}")
        assert z["losses"] == b["losses"] and not p7["n_differ"], p7["differ"]
        want = dp_want(STEPS, 1, n_leaves)
        assert z["launches"] == want, (z["launches"], want)
        assert b["launches"] == want, (b["launches"], want)
        assert z["entry_launches"]["hybrid_update"] == STEPS
        assert z["entry_launches"]["hybrid_update_leaves"] == 0
        assert b["entry_launches"]["hybrid_update_leaves"] == \
            STEPS * -(-n_leaves // MAX_LEAVES)
        nb = z["n_buckets"]
        calls = z["collectives_a_step"]
        assert calls["reduce_scatter_tensor"] == nb, calls
        assert calls["all_gather_into_tensor"] == nb, calls
        # the one all-reduce is the stacked scalar metrics, not a gradient
        assert calls["all_reduce"] == 1, calls
        assert max(z["collective_elements"]["all_reduce"]) < 64, calls
        ck = rec["ckpt"]
        log(f"  worker {r}: resumed from {ck['resumed_from']}, "
            f"{len(ck['resume_differ'])} of {ck['entries']} entries differ "
            f"{ck['resume_differ'][:5]}; the step-{ZERO_CKPT_EVERY} ZeRO "
            f"checkpoint in the per-leaf run: losses {ck['to_tree_losses']}"
            f" vs {ck['to_tree_unbroken_losses']}, "
            f"{len(ck['to_tree_differ'])} entries differ")
        assert ck["resumed_from"] == ZERO_CKPT_EVERY
        assert not ck["resume_differ"] and not ck["to_tree_differ"]
        assert ck["to_tree_losses"] == ck["to_tree_unbroken_losses"]
        assert ck["opt_layout"] == "zero_stream"
        for name, pair in rec["reduced"].items():
            if ZERO_PAIRS[name][1]:
                log(f"  worker {r} 13b {name}: ZeRO {pair['zero_losses']} "
                    f"vs {pair['losses']}, {pair['n_differ']} of "
                    f"{pair['entries']} entries not bitwise equal "
                    f"{pair['differ'][:5]}")
                assert pair["bitwise"], (name, pair["differ"])
            else:
                log(f"  worker {r} 13b {name}: ZeRO {pair['zero_losses']} "
                    f"vs {pair['losses']} (loss rel {pair['loss_rel']:.3g});"
                    f" worst excess over rtol 1e-2 / atol 1e-4 "
                    f"{pair['max_excess']:.3g} at {pair['worst']}; "
                    f"{pair['differ_bitwise']} entries not bitwise")
                assert pair["max_excess"] <= 0 and \
                    pair["loss_rel"] <= ZERO_PAIR_TOL["rtol"], (name, pair)
        lars = rec["reduced"]["lars"]["entry_launches"]
        assert lars["seg_sq_partials"] == 3 and lars["lars_update"] == 3, lars
        assert lars["hybrid_update"] == 0, lars
    assert len({rec["path7"]["zero"]["digest"] for rec in ranks}) == 1
    z0, b0 = ranks[0]["path7"]["zero"], ranks[0]["path7"]["bucketed"]
    log(f"  main path 7 ({z0['plan']}, {z0['shard_elements']} elements a "
        f"worker): median step {z0['median_step_ms']:.2f} ms (ZeRO) vs "
        f"{b0['median_step_ms']:.2f} ms (bucketed), two processes on one "
        f"card over gloo: not a user's figure; peak "
        f"{[rec['path7']['zero']['peak_gib'] for rec in ranks]} GiB (ZeRO) "
        f"vs {[rec['path7']['bucketed']['peak_gib'] for rec in ranks]} GiB; "
        f"optimizer state {z0['opt_state_bytes']} vs "
        f"{b0['opt_state_bytes']} bytes a worker; collectives a step "
        f"{z0['collectives_a_step']}")
    upd = zero_update_timing(torch, z0["shard_elements"])
    log(f"  hybrid_update (decay stream) at the shard, {upd['elements']} "
        f"elements: {upd['ms']:.4f} ms vs bound {upd['bound_ms']:.4f} ms "
        f"({upd['bound_ms'] / upd['ms']:.0%}), plain {upd['plain_ms']:.4f} "
        f"ms, bitwise {upd['bitwise']}")
    assert upd["bitwise"], upd
    log(f"  worker seconds: path 7 {ranks[0]['path7_s']:.1f}, checkpoints "
        f"{ranks[0]['ckpt_s']:.1f}, 13b {ranks[0]['reduced_s']:.1f}")
    return {"workers": ranks, "hybrid_update_shard": upd}, z0["launches"]


HIER_WORKERS = 4  # main path 8: four processes share the one card, 2x2
HIER_MESH = (2, 2)
HIER_BUILD = dict(hier_split=1, dp_axes=("data", "model"),
                  mesh_shape=HIER_MESH)
# ZeRO's stacked metrics carry one more entry: gloo's ring at 4 workers
# may add the workers' losses in another order (test_torch_zero_dp.py)
HIER_LOSS_RTOL_ZERO = 2.4e-7
# flat at 4 workers against the hierarchical step: the first loss
# bitwise (no update yet), the loss after the first update within this
# (tests/test_torch_hierarchical.py); later steps only logged: at full
# width and 128 images the warm-up's loss climbs from 7.5 to ~25 in two
# steps, and the rounding differences grow with it
HIER_FLAT_FIRST_RTOL = 1e-3
HIER_PRIM_ELEMS = 1 << 22  # the primitives' bucket, elements a worker
# 14b: the reduced model's runs, each under hier:1 at 2x2 ...
HIER_RUNS = {
    "bucketed": {},
    "overlap": dict(overlap_comm=True, bucket_bytes=ZERO_SMALL_BUCKET),
    "bucketed_ef": dict(error_feedback=True),
    "overlap_ef": dict(overlap_comm=True, error_feedback=True,
                       bucket_bytes=ZERO_SMALL_BUCKET),
    "zero_overlap_ef": dict(zero_dp=True, overlap_comm=True,
                            error_feedback=True,
                            bucket_bytes=ZERO_SMALL_BUCKET),
    "lars": dict(lars=True),
    "zero_lars": dict(lars=True, zero_dp=True),
    "momentum": dict(opt="momentum_sgd"),
    "zero_momentum": dict(opt="momentum_sgd", zero_dp=True),
    "overlap_lars": dict(lars=True, overlap_comm=True,
                         bucket_bytes=ZERO_SMALL_BUCKET),
    "zero_overlap_lars": dict(lars=True, overlap_comm=True, zero_dp=True,
                              bucket_bytes=ZERO_SMALL_BUCKET),
}
# ... and its pairs: (run, reference, loss rtol; None: the pair
# tolerance, not bitwise)
HIER_PAIRS = {
    "overlap": ("overlap", "bucketed", 0.0),
    "overlap_ef": ("overlap_ef", "bucketed_ef", 0.0),
    "zero_overlap_ef": ("zero_overlap_ef", "overlap_ef",
                        HIER_LOSS_RTOL_ZERO),
    "zero_lars": ("zero_lars", "lars", HIER_LOSS_RTOL_ZERO),
    "zero_momentum": ("zero_momentum", "momentum", HIER_LOSS_RTOL_ZERO),
    "zero_overlap_lars": ("zero_overlap_lars", "overlap_lars", None),
}


def hier_groups():
    """This worker's hierarchy of main path 8, with the process groups
    its steps use (made once per worker group, so these are the same
    groups)."""
    from repro_torch.distributed.bucketing import (hierarchy_groups,
                                                   make_hierarchy)
    return hierarchy_groups(make_hierarchy(
        ("data", "model"), dict(zip(("data", "model"), HIER_MESH)), 1))


def group_collective_check(torch, train_step, state, data, hier):
    """One more step with ``all_reduce``, ``reduce_scatter_tensor`` and
    ``all_gather_into_tensor`` counted by the group they ran in (inner,
    outer or world)."""
    import torch.distributed as dist
    names = ("reduce_scatter_tensor", "all_gather_into_tensor", "all_reduce")
    real = {k: getattr(dist, k) for k in names}
    calls = {}

    def counted(name):
        def call(*a, **kw):
            g = kw.get("group")
            where = ("inner" if g is hier.inner_group else
                     "outer" if g is hier.outer_group else "world")
            calls[f"{name}/{where}"] = calls.get(f"{name}/{where}", 0) + 1
            return real[name](*a, **kw)
        return call

    for k in names:
        setattr(dist, k, counted(k))
    try:
        state, metrics = train_step(state, data.batch_at(3000))
        float(metrics["loss"])
        torch.cuda.synchronize()
    finally:
        for k in names:
            setattr(dist, k, real[k])
    return calls


def hier_path8(torch, libs, rank: int):
    """Phase 14 in one worker: (B) ZeRO + hier, (A) bucketed + hier and
    (C) flat bucketed at 4 workers, each through the ``Trainer`` from one
    seed; the collectives of a step per group for A and B."""
    from repro_torch.configs import get_config

    cfg = get_config("resnet50")
    hier = hier_groups()
    runs = {}
    for name, zero, build in (("B", True, HIER_BUILD),
                              ("A", False, HIER_BUILD), ("C", False, {})):
        res, sh, step, data, put, launches, entries, peak = zero_trainer(
            torch, libs, cfg, STEPS, zero, workers=HIER_WORKERS,
            build=build)
        state = res.state
        if zero:
            plan = sh.zero_plan
        walls = [h["time"] * 1e3 for h in res.history[1:]]
        rec = {"losses": [h["loss"] for h in res.history],
               "step_ms": walls, "median_step_ms": statistics.median(walls),
               "peak_gib": peak, "launches": launches,
               "entry_launches": entries,
               "eval": {k: res.epoch_history[-1][k] for k in ("top1", "loss")},
               "digest": param_digest(state)}
        if name in ("A", "B"):
            runs[name + "_bits"] = zero_bits(torch, state, plan,
                                             HIER_WORKERS, rank)
            rec["collectives_a_step"] = group_collective_check(
                torch, step, state, data, hier)
            rec["n_buckets"] = plan.n_buckets
        if name == "A":
            params_a = {k: v.detach().clone()
                        for k, v in state["params"].items()}
        if name == "C":
            rel = {k: float((v.double() - params_a[k].double()).norm()
                            / params_a[k].double().norm().clamp_min(1e-30))
                   for k, v in state["params"].items()}
            rec["param_rel_max"] = max(rel.values())
            rec["param_rel_worst"] = max(rel, key=rel.get)
            num = sum(float((v.double() - params_a[k].double()).square()
                            .sum()) for k, v in state["params"].items())
            den = sum(float(v.double().square().sum())
                      for v in params_a.values())
            rec["param_rel_norm"] = (num / den) ** 0.5
        runs[name] = rec
        del res, state, step, data, put
    differ = zero_differ(torch, runs.pop("B_bits"), runs.pop("A_bits"))
    return {**runs, "n_differ": len(differ), "differ": differ[:10],
            "plan": plan.describe()}


def hier_primitives(torch, rank: int):
    """The hierarchical primitives on the card against the flat gloo
    collectives, on CUDA tensors of ``HIER_PRIM_ELEMS`` elements a worker,
    bf16 and f16: the all-reduce and the reduce-scatter bitwise on exact
    data (integers in [-64, 64]: every partial sum is exact in the wire
    dtype, and gloo's flat sum rounds each add), the all-gather bitwise
    on normal data, and the two-level all-reduce's chunk bitwise the
    double scatter's on normal data; host ms of each, gloo. Also the
    flat sum's divergence by design on normal data: gloo rounds to the
    wire dtype after each add, the two-level schedule (the JAX package's
    bits) once: the elements that differ, and the largest difference in
    ulps of the wire dtype at the sum of the four magnitudes."""
    import torch.distributed as dist
    from repro_torch.distributed.bucketing import (
        hierarchical_all_gather, hierarchical_psum, hierarchical_psum_scatter)

    hier = hier_groups()
    n, w = HIER_PRIM_ELEMS, HIER_WORKERS
    c = n // w
    gen = torch.Generator(device="cuda").manual_seed(17 + rank)
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for dt in (torch.bfloat16, torch.float16):
        exact = torch.randint(-64, 65, (n,), generator=gen,
                              device="cuda").to(dt)
        fuzzy = torch.randn(n, generator=gen, device="cuda").to(dt)
        h, flat = exact.clone(), exact.clone()
        ms_h = timed(lambda: hierarchical_psum(h, hier))
        ms_f = timed(lambda: dist.all_reduce(flat))
        sc_h, sc_f = exact.new_empty(c), exact.new_empty(c)
        ms_sh = timed(lambda: hierarchical_psum_scatter(sc_h, exact, hier))
        ms_sf = timed(lambda: dist.reduce_scatter_tensor(sc_f, exact))
        hf = fuzzy.clone()
        hierarchical_psum(hf, hier)
        scf = fuzzy.new_empty(c)
        hierarchical_psum_scatter(scf, fuzzy, hier)
        ag_h, ag_f = fuzzy.new_empty(n), fuzzy.new_empty(n)
        ms_gh = timed(lambda: hierarchical_all_gather(ag_h, scf, hier))
        ms_gf = timed(lambda: dist.all_gather_into_tensor(ag_f, scf))
        ff = fuzzy.clone()
        dist.all_reduce(ff)
        mag = fuzzy.float().abs()
        dist.all_reduce(mag)
        mant = 7 if dt == torch.bfloat16 else 10
        ulp = torch.pow(2.0, torch.floor(torch.log2(
            mag.clamp_min(2.0 ** -14))) - mant)
        flat_ulps = ((ff.float() - hf.float()).abs() / ulp).max()
        out[str(dt).split(".")[-1]] = {
            "flat_differ": int((ff != hf).sum()),
            "flat_max_ulps": float(flat_ulps),
            "psum_exact_bitwise": torch.equal(h, flat),
            "scatter_exact_bitwise": torch.equal(sc_h, sc_f),
            "gather_bitwise": torch.equal(ag_h, ag_f),
            "chunk_bitwise": torch.equal(scf, hf[rank * c:(rank + 1) * c]),
            "on_card": all(t.device.type == "cuda" for t in (h, sc_h, ag_h)),
            "host_ms": {"psum": ms_h, "all_reduce": ms_f,
                        "psum_scatter": ms_sh, "reduce_scatter": ms_sf,
                        "all_gather_hier": ms_gh, "all_gather": ms_gf}}
    return out


def hier_reduced_pairs(torch, libs, rank: int):
    """Phase 14b in one worker: the reduced ResNet in f32, every kernel
    on, three steps of each run of ``HIER_RUNS`` under hier:1 at 2x2 from
    one seed, compared pair by pair (``HIER_PAIRS``)."""
    from repro_torch.configs import (InputConfig, OptimizerConfig,
                                     get_config, reduced_config)
    from repro_torch.launch.train import build_train_setup

    cfg = reduced_config(get_config("resnet50"))
    runs = {}
    for name, kw in HIER_RUNS.items():
        kw = dict(kw)
        opt_cfg, smoothing = (lars_recipe(3, 4) if kw.pop("lars", False)
                              else (OptimizerConfig(kind=kw.pop(
                                  "opt", "rmsprop_warmup")), 0.0))
        _, state, step, data, put, sh = build_train_setup(
            cfg, global_batch=8 * HIER_WORKERS, seq_len=0, opt_cfg=opt_cfg,
            steps_per_epoch=4, dp_mode="shardmap",
            compute_dtype=torch.float32, fused_bn=True,
            use_fused_kernel=True, compression="bf16+bucketed",
            label_smoothing=smoothing,
            input_cfg=InputConfig(fused=True, augment=False), seed=3,
            device="cuda", **HIER_BUILD, **kw)
        losses = []
        for i in range(3):
            state, metrics = step(state, put(data.batch_at(i)).take())
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        runs[name] = (losses, state, sh.zero_plan)
    out = {}
    for pair, (a, b, loss_rtol) in HIER_PAIRS.items():
        (la, sa, plan), (lb, sb, _) = runs[a], runs[b]
        if plan is not None:
            ba = zero_bits(torch, sa, plan, HIER_WORKERS, rank)
            bb = zero_bits(torch, sb, plan, HIER_WORKERS, rank)
        else:
            ba, bb = train_state_bits(sa), train_state_bits(sb)
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(la, lb))
        rec = {"losses": la, "ref_losses": lb, "loss_rel": loss_rel,
               "entries": len(ba)}
        if loss_rtol is not None:
            differ = zero_differ(torch, ba, bb)
            rec.update(differ=differ[:10], n_differ=len(differ),
                       ok=not differ and loss_rel <= loss_rtol,
                       losses_bitwise=la == lb)
        else:
            worst = {}
            for k, v in ba.items():
                if k in bb and k.startswith(("params/", "opt/")) \
                        and k != "opt/step":
                    ref = bb[k].double()
                    excess = ((v.double() - ref).abs()
                              - ZERO_PAIR_TOL["atol"]
                              - ZERO_PAIR_TOL["rtol"] * ref.abs())
                    worst[k] = float(excess.max())
            rec.update(max_excess=max(worst.values()),
                       worst=max(worst, key=worst.get),
                       ok=max(worst.values()) <= 0
                       and loss_rel <= ZERO_PAIR_TOL["rtol"],
                       differ_bitwise=sum(not torch.equal(ba[k], bb[k])
                                          for k in worst))
        out[pair] = rec
    return out


def hier_cards_worker(rank: int, out_dir: str) -> None:
    """One of phase 14's four workers, all on the one card, joined over
    gloo as a 2x2 layout: main path 8 (14), the primitives and the
    reduced pairs (14b), cuDNN deterministic. Writes ``rank{rank}.json``."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import bucket_ops as bo
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_bn as fb
    from repro_torch.kernels import fused_input as fi
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import rmsnorm as rn
    libs = (fb, fu, bo, fi, fa, rn)

    torch.cuda.set_device(0)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=HIER_WORKERS)
    try:
        t0 = time.perf_counter()
        out = {"path8": hier_path8(torch, libs, rank)}
        out["path8_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["primitives"] = hier_primitives(torch, rank)
        out["reduced"] = hier_reduced_pairs(torch, libs, rank)
        out["reduced_s"] = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        from repro_torch.distributed import shutdown
        shutdown()  # the subgroups too


def hier_phase(torch):
    """Phases 14 and 14b: four processes share the card over gloo as a
    2x2 layout (``--mesh 2x2 --comm-plan hier:1``). 14, main path 8:
    ResNet-50 at full width, 32 images a worker (128 in all), bf16, fused
    BN, update and input, ``bf16+bucketed`` (64 MiB), rmsprop_warmup +
    slow_start: (A) bucketed + hier, (B) ZeRO + hier and (C) flat
    bucketed at 4 workers, 8 steps and one eval batch each through the
    ``Trainer`` from one seed. B is bitwise A (parameters, BN state,
    ``opt.step``, ``delta`` / ``m`` as the worker's shard; the losses
    within 2.4e-7); C's first loss bitwise A's, the loss after the
    first update within rtol 1e-3, the rest and the parameters'
    relative difference logged; collectives a step per group;
    launches a step as path 2's (A) and path 7's (B); the primitives on
    the card. 14b: the reduced ResNet in f32, every kernel on, the pairs
    of ``HIER_PAIRS``. Returns (record, rank 0's launches of A and B)."""
    import shutil
    import tempfile


    root = tempfile.mkdtemp(prefix="chip_smoke_hier_")
    try:
        spawn(hier_cards_worker, args=(root,), nprocs=HIER_WORKERS)
        ranks = []
        for r in range(HIER_WORKERS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    from repro_torch.kernels.fused_update import MAX_LEAVES
    n_leaves = 161
    want = dp_want(STEPS, 1, n_leaves)
    for r, rec in enumerate(ranks):
        p8 = rec["path8"]
        a, b, c = p8["A"], p8["B"], p8["C"]
        loss_rel = max(abs(x - y) / abs(y)
                       for x, y in zip(b["losses"], a["losses"]))
        log(f"  worker {r}: ZeRO + hier losses {b['losses']} vs bucketed + "
            f"hier {a['losses']} (largest rel {loss_rel:.3g}); "
            f"{p8['n_differ']} entries not bitwise equal {p8['differ'][:5]}")
        assert not p8["n_differ"], p8["differ"]
        assert loss_rel <= HIER_LOSS_RTOL_ZERO, (a["losses"], b["losses"])
        flat_rel = [abs(x - y) / abs(y)
                    for x, y in zip(c["losses"], a["losses"])]
        log(f"  worker {r}: flat at 4 workers losses {c['losses']}, rel "
            f"against A by step {[f'{x:.3g}' for x in flat_rel]}; "
            f"parameters after the run: relative norm "
            f"{c['param_rel_norm']:.3g}, largest relative leaf difference "
            f"{c['param_rel_max']:.3g} at {c['param_rel_worst']}")
        assert c["losses"][0] == a["losses"][0], (a["losses"], c["losses"])
        assert flat_rel[1] <= HIER_FLAT_FIRST_RTOL, (a["losses"],
                                                     c["losses"])
        for run in (a, b, c):
            assert run["launches"] == want, (run["launches"], want)
        assert b["entry_launches"]["hybrid_update"] == STEPS
        assert b["entry_launches"]["hybrid_update_leaves"] == 0
        assert a["entry_launches"]["hybrid_update_leaves"] == \
            STEPS * -(-n_leaves // MAX_LEAVES)
        nb = a["n_buckets"]
        assert a["collectives_a_step"] == {
            "reduce_scatter_tensor/inner": nb, "all_reduce/outer": nb,
            "all_gather_into_tensor/inner": nb,
            "all_reduce/world": 1}, a["collectives_a_step"]
        assert b["collectives_a_step"] == {
            "reduce_scatter_tensor/inner": nb,
            "reduce_scatter_tensor/outer": nb,
            "all_gather_into_tensor/outer": nb,
            "all_gather_into_tensor/inner": nb,
            "all_reduce/world": 1}, b["collectives_a_step"]
        for dt, prim in rec["primitives"].items():
            checks = {k: v for k, v in prim.items()
                      if not k.startswith(("host_ms", "flat_"))}
            assert all(checks.values()), (r, dt, checks)
        for name, pair in rec["reduced"].items():
            if "n_differ" in pair:
                log(f"  worker {r} 14b {name}: {pair['losses']} vs "
                    f"{pair['ref_losses']} (losses bitwise "
                    f"{pair['losses_bitwise']}); {pair['n_differ']} of "
                    f"{pair['entries']} entries not bitwise equal "
                    f"{pair['differ'][:5]}")
            else:
                log(f"  worker {r} 14b {name}: {pair['losses']} vs "
                    f"{pair['ref_losses']} (loss rel {pair['loss_rel']:.3g});"
                    f" worst excess over rtol 1e-2 / atol 1e-4 "
                    f"{pair['max_excess']:.3g} at {pair['worst']}; "
                    f"{pair['differ_bitwise']} entries not bitwise")
            assert pair["ok"], (name, pair)
    for run in ("A", "B", "C"):
        assert len({rec["path8"][run]["digest"] for rec in ranks}) == 1, run
    p0 = ranks[0]["path8"]
    log(f"  main path 8 ({p0['plan']}): median step A (bucketed + hier) "
        f"{p0['A']['median_step_ms']:.2f} ms, B (ZeRO + hier) "
        f"{p0['B']['median_step_ms']:.2f} ms, C (flat, 4 workers) "
        f"{p0['C']['median_step_ms']:.2f} ms: four processes on one card "
        f"over gloo, not a user's figure; peak GiB a worker A "
        f"{[rec['path8']['A']['peak_gib'] for rec in ranks]}, B "
        f"{[rec['path8']['B']['peak_gib'] for rec in ranks]}, C "
        f"{[rec['path8']['C']['peak_gib'] for rec in ranks]}; collectives a "
        f"step A {p0['A']['collectives_a_step']}, B "
        f"{p0['B']['collectives_a_step']}")
    for dt, prim in ranks[0]["primitives"].items():
        log(f"  primitives {dt} ({HIER_PRIM_ELEMS} elements a worker, "
            f"gloo host ms): " + ", ".join(
                f"{k} {v:.1f}" for k, v in prim["host_ms"].items())
            + f"; the flat sum differs from the two-level one in "
            f"{prim['flat_differ']} elements, at most "
            f"{prim['flat_max_ulps']:.2f} ulps at the sum of magnitudes")
    log(f"  worker seconds: path 8 {ranks[0]['path8_s']:.1f}, primitives "
        f"and 14b {ranks[0]['reduced_s']:.1f}")
    return {"workers": ranks}, (p0["A"]["launches"], p0["B"]["launches"])


# (B, Sq, Sk, Hq, Hkv, Dh, causal, window) of phase 3d: the serving
# path's prefill first, then lengths 1 and 1000, Sq != Sk, non-causal, a
# causal window of 256, groups 1, 4 and 8, Dh 32 and 128, the 64-row
# tile edges (one row past a tile, one short of it, a single key), and Dh
# 96 and 112 (phi-3-vision's and zamba2-7b's heads: MHA, 32 kv heads),
# each with a tile-edge case of its own
FLASH_CASES = [
    (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 8, 64, True, None),
    (2, 1, 1, 8, 8, 64, True, None),
    (2, 1000, 1000, 32, 8, 64, True, None),
    (2, 300, 1000, 8, 2, 64, True, None),
    (2, 1000, 300, 8, 2, 64, False, None),
    (2, 1024, 1024, 8, 8, 64, False, None),
    (2, 1000, 1000, 16, 4, 64, True, 256),
    (1, 777, 777, 8, 1, 128, True, None),
    (2, 513, 513, 8, 2, 32, True, None),
    (1, 65, 63, 8, 8, 64, True, None),
    (2, 129, 129, 32, 8, 128, True, None),
    (1, 64, 1, 4, 1, 32, False, None),
    (1, 1000, 1000, 32, 32, 96, True, None),
    (1, 1000, 1000, 32, 32, 112, True, None),
    (1, 65, 63, 8, 8, 96, True, None),
    (2, 129, 129, 8, 4, 112, False, None),
]
# the bf16 case whose q, k and v are views 8 bytes into their buffers
MISALIGNED_CASE = (2, 300, 300, 8, 2, 64, True, None)
# (rows, d) of phase 3d: a prefill's and a decode step's norm sites, odd
# row counts, the reduced config's d = 128, a d with no 16-byte loads
RMSNORM_CASES = [(SERVE_BATCH * SERVE_PROMPT, 2048), (SERVE_BATCH, 2048),
                 (333, 2048), (1001, 128), (5, 100)]
# kernel vs plain: flash f32 rtol 1e-5 / atol 1e-6 (its sums run in
# another order than the plain full softmax), RMSNorm f32 rtol 1e-6 (the
# row sum's order moves inv by an ulp); in bf16, beyond those, flash
# within one bf16 ulp (one rounding of the f32 result) and RMSNorm within
# two (it rounds twice, x * inv and then the product with the scale: a
# flip of the first rounding moves the second product by up to ~2 ulps)
LM_TOL = {"flash_attention": dict(rtol=1e-5, atol=1e-6),
          "rmsnorm": dict(rtol=1e-6, atol=0.0)}
BF16_ULPS = {"flash_attention": 1, "rmsnorm": 2}
# flash vs naive attention, bf16 prefill logits at full width, relative
# norm: the naive path rounds scores and probabilities to bf16 (2^-8
# each) where the flash kernel keeps them in f32, and 16 layers of
# random weights carry that drift to the logits (~2e-2, PERF.md §6); the
# bound leaves room above it
NAIVE_REL_TOL = 5e-2


def live_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """The (q, k) pairs the masks keep, positions from 0 on both sides."""
    import numpy as np
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= k <= q
    if window is not None:
        keep &= q - k < window
    return int(keep.sum())


def flash_bound(case, esize: int):
    """(bound ms at the bf16 tensor-core peak, the same at the f32
    CUDA-core peak, what bounds the first): the larger of q, k, v and out
    moved once over the HBM rate and 4 * Dh flops per live (q, k) pair
    per batch row and query head."""
    b, sq, sk, hq, hkv, dh, causal, window = case
    nbytes = esize * b * dh * (2 * sq * hq + 2 * sk * hkv)
    flops = 4 * b * hq * dh * live_pairs(sq, sk, causal, window)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_bf16, t_f32 = flops / BF16_FLOPS_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_bf16) * 1e3, max(t_bytes, t_f32) * 1e3,
            "bytes" if t_bytes >= t_bf16 else "operations", flops)


def _bf16_ulp_check(torch, name, got, want, ulps, rtol, atol) -> float:
    """Raise unless |got - want| <= ``ulps`` bf16 ulps of want + atol +
    rtol * |want| everywhere; returns the largest |got - want|."""
    got, want = got.float(), want.float()
    mag = want.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    err = (got - want).abs()
    if bool((err > ulps * ulp + atol + rtol * want.abs()).any()):
        raise AssertionError(f"{name}: beyond {ulps} bf16 ulp, max error "
                             f"{err.max().item():.3g}")
    return err.max().item()


def lm_kernel_phase(torch):
    """Phase 3d: ``flash_attention`` and ``rmsnorm`` against their plain
    versions at every case, bf16 and f32, each case timed (kernel, plain,
    library) with its bound. Returns per-prefill totals at the serving
    path's shapes in bf16 (16 flash launches at the first case, 33
    rmsnorm launches at the first) and every case's record."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    dtypes = (("bf16", torch.bfloat16), ("f32", torch.float32))
    records = {"flash_attention": [], "rmsnorm": []}
    for case in FLASH_CASES:
        b, sq, sk, hq, hkv, dh, causal, window = case
        for dname, dt in dtypes:
            q, k, v = (torch.randn(b, s, h, dh, generator=gen, device=dev)
                       .to(dt) for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.PLAIN["flash_attention"](q, k, v, causal, window)
            torch.cuda.synchronize()
            name = f"flash_attention {dname} {case}"
            tol, ulps = LM_TOL["flash_attention"], BF16_ULPS["flash_attention"]
            if dname == "f32":
                torch.testing.assert_close(got, want, **tol, msg=lambda m: (
                    f"{name}: {m}"))
                err = (got - want).abs().max().item()
            else:
                err = _bf16_ulp_check(torch, name, got, want, ulps, **tol)
            bound_ms, f32_bound_ms, bound_by, flops = flash_bound(
                case, q.element_size())
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            rec = {"case": list(case), "dtype": dname, "max_abs_err": err,
                   "ms": time_ms(torch, lambda: fa.flash_attention(
                       q, k, v, causal=causal, window=window)),
                   "plain_ms": time_ms(torch, lambda: fa.PLAIN[
                       "flash_attention"](q, k, v, causal, window)),
                   "library_ms": None, "bound_ms": bound_ms,
                   "bound_by": bound_by, "f32_bound_ms": f32_bound_ms,
                   "flops": flops}
            if window is None:  # SDPA takes a window only as a mask
                rec["library_ms"] = time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True))
            records["flash_attention"].append(rec)
            lib = rec["library_ms"]
            log(f"  flash {dname:4s} {case}: {rec['ms']:.4f} ms (plain "
                f"{rec['plain_ms']:.4f}, sdpa "
                f"{'-' if lib is None else f'{lib:.4f}'}, bound "
                f"{bound_ms:.4f} bf16 tc / {f32_bound_ms:.4f} f32), max err "
                f"{err:.3g}")
            del q, k, v, got, want
    records["flash_misaligned"] = misaligned_flash(torch, fa, gen)
    for rows, d in RMSNORM_CASES:
        for dname, dt in dtypes:
            x = (torch.randn(rows, d, generator=gen, device=dev) * 2
                 + 0.3).to(dt)
            # the serving path's scale is a parameter in x's dtype already
            st = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(dt)
            tol, ulps = LM_TOL["rmsnorm"], BF16_ULPS["rmsnorm"]
            err = 0.0
            for order, round_inv in (("pallas", False), ("model", True)):
                got = rn.rmsnorm(x, st, round_inv=round_inv)
                want = rn.PLAIN["rmsnorm"](x, st, 1e-5, round_inv)
                torch.cuda.synchronize()
                name = f"rmsnorm {dname} rows={rows} d={d} {order} order"
                if dname == "f32":
                    torch.testing.assert_close(got, want, **tol,
                                               msg=lambda m: f"{name}: {m}")
                    e = (got - want).abs().max().item()
                else:
                    e = _bf16_ulp_check(torch, name, got, want, ulps, **tol)
                err = max(err, e)
            es = x.element_size()
            bound_ms, bound_by = bound(es * (2 * rows * d + d), 4 * rows * d)
            # timed in the model's order, the one the serving path runs;
            # kernel, plain version and F.rms_norm take the same scale
            rec = {"rows": rows, "d": d, "dtype": dname, "max_abs_err": err,
                   "ms": time_ms(torch, lambda: rn.rmsnorm(
                       x, st, round_inv=True)),
                   "pallas_order_ms": time_ms(torch, lambda: rn.rmsnorm(
                       x, st)),
                   "plain_ms": time_ms(torch, lambda: rn.PLAIN["rmsnorm"](
                       x, st, 1e-5, True)),
                   "library_ms": time_ms(torch, lambda: F.rms_norm(
                       x, (d,), st, 1e-5)),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            records["rmsnorm"].append(rmsnorm_shares(torch, rec, x, st))
            log(f"  rmsnorm {dname:4s} {rows:5d} x {d:4d}: {rec['ms']:.4f} "
                f"ms (Pallas order {rec['pallas_order_ms']:.4f}, plain "
                f"{rec['plain_ms']:.4f}, F.rms_norm "
                f"{rec['library_ms']:.4f}, bound {bound_ms:.4f}, "
                f"{rmsnorm_share_text(rec)}), max err {err:.3g} (both "
                f"orders)")
    n_layers = 16  # llama3.2-1b
    per_prefill = {"flash_attention": n_layers, "rmsnorm": 2 * n_layers + 1}
    totals = {}
    for k in ("flash_attention", "rmsnorm"):
        recs = records[k]
        first = next(r for r in recs if r["dtype"] == "bf16")
        n = per_prefill[k]
        totals[k] = {f: (None if first[f] is None else n * first[f])
                     for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
        totals[k].update(
            max_abs_err=max(r["max_abs_err"] for r in recs),
            bound_by=first["bound_by"], ms_per_launch=first["ms"],
            unit=f"per prefill ({n} launches at the first case, bf16)")
    dec = next(r for r in records["rmsnorm"]
               if r["dtype"] == "bf16" and r["rows"] == SERVE_BATCH)
    totals["rmsnorm"]["decode_launch_ms"] = dec["ms"]
    totals["rmsnorm"]["decode_library_ms"] = dec["library_ms"]
    totals["rmsnorm"]["decode_bound_ms"] = dec["bound_ms"]
    totals["rmsnorm"]["decode_step_ms"] = per_prefill["rmsnorm"] * dec["ms"]
    totals["rmsnorm"]["decode_step_bound_ms"] = \
        per_prefill["rmsnorm"] * dec["bound_ms"]
    first = records["flash_attention"][0]
    totals["flash_attention"]["f32_bound_ms"] = \
        n_layers * first["f32_bound_ms"]
    return totals, records


_EMPTY_KERNEL_MS = {}


def empty_kernel_ms(torch, blocks: int, threads: int) -> float:
    """An empty kernel (``csrc/launch_floor.cu``) on ``blocks`` x
    ``threads``, timed by the same CUDA-graph replay as the kernels: the
    least time a launch on that grid takes (timed once a grid)."""
    if (blocks, threads) not in _EMPTY_KERNEL_MS:
        from repro_torch.kernels._launch import I32, P, Library, stream
        lib = Library("launch_floor", {"launch_floor": [I32, I32, P]})
        _EMPTY_KERNEL_MS[blocks, threads] = time_ms(torch, lambda: lib.launch(
            "launch_floor", blocks, threads, stream()))
    return _EMPTY_KERNEL_MS[blocks, threads]


def rmsnorm_grid(x, st):
    """(blocks, threads a block) of rmsnorm's launch plan for x."""
    from repro_torch.kernels import rmsnorm as rn
    plan = rn.plan_for(x, st, x)
    return plan.grid, 32 * plan.warps * plan.rows_per_block


def rmsnorm_shares(torch, rec, x, st):
    """``rec`` (an rmsnorm case's record) with its share of the bound; at
    decode rows, where one launch costs more than the bytes, also the
    empty kernel on the launch's own grid (``floor_ms``) and the larger
    of the two as its least time (``least_ms``, ``least_share``)."""
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    if "cold_ms" in rec:
        rec["cold_share"] = rec["bound_ms"] / rec["cold_ms"]
    if rec["rows"] <= SERVE_BATCH:
        rec["floor_ms"] = empty_kernel_ms(torch, *rmsnorm_grid(x, st))
        rec["least_ms"] = max(rec["bound_ms"], rec["floor_ms"])
        rec["least_share"] = rec["least_ms"] / rec["ms"]
    return rec


def rmsnorm_share_text(rec) -> str:
    if "least_ms" in rec:
        return (f"{rec['least_share']:.0%} of its least time, the empty "
                f"kernel's {rec['floor_ms'] * 1e3:.2f} us")
    if "cold_ms" in rec:
        return (f"{rec['bound_share']:.0%} of bound; L2 cold "
                f"{rec['cold_ms']:.4f} ms, {rec['cold_share']:.0%}")
    return f"{rec['bound_share']:.0%} of bound"


def launch_floor_phase(torch):
    """The empty kernel at rmsnorm's decode grid (the launch plan of a
    decode step's 8 rows of 2,048 bf16) and at one warp."""
    x = torch.empty(SERVE_BATCH, 2048, dtype=torch.bfloat16, device="cuda")
    blocks, threads = rmsnorm_grid(x, x[0])
    out = {"decode_grid": [blocks, threads],
           "decode_grid_ms": empty_kernel_ms(torch, blocks, threads),
           "one_warp_ms": empty_kernel_ms(torch, 1, 32)}
    log(f"  empty kernel: {out['decode_grid_ms'] * 1e3:.2f} us at "
        f"{blocks} x {threads} threads (rmsnorm's decode grid), "
        f"{out['one_warp_ms'] * 1e3:.2f} us at 1 x 32")
    return out


# rmsnorm's widths in the registry (every config's RMSNorm d_model, and
# the Mamba2 and mLSTM out_norm width d_in)
RMSNORM_WIDTHS = (2048, 3072, 3584, 4096, 5120, 7168, 8192)


def rmsnorm_order_phase(torch):
    """rmsnorm's row sum order is set by d and the dtype alone: at each
    width of ``RMSNORM_WIDTHS``, in bf16 and f32, rows of a prefill batch
    (phi-3-vision's 12,800 at d 3,072, 8,192 elsewhere) get the same bits
    normalized in the batch, among 8 rows, alone, and as a view 2
    elements into its buffer (the generic instance). Returns the number
    of rows compared."""
    from repro_torch.kernels import rmsnorm as rn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    compared = 0
    for d in RMSNORM_WIDTHS:
        rows = SERVE_BATCH * (SERVE_PROMPT + (VLM_PATCHES if d == 3072
                                              else 0))
        mid = rows // 2
        for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            x = (torch.randn(rows, d, generator=gen, device=dev) * 2
                 + 0.3).to(dt)
            st = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(dt)
            full = rn.rmsnorm(x, st, round_inv=True)
            eight = rn.rmsnorm(x[mid:mid + SERVE_BATCH], st, round_inv=True)
            buf = torch.empty(SERVE_BATCH * d + 2, dtype=dt, device=dev)
            moved = buf[2:].view(SERVE_BATCH, d)
            moved.copy_(x[mid:mid + SERVE_BATCH])
            assert rn.plan_for(moved, st, moved).held == 0
            shifted = rn.rmsnorm(moved, st, round_inv=True)
            name = f"rmsnorm {dname} d={d}"
            _bitwise(f"{name}: 8 rows vs the same rows of {rows}", eight,
                     full[mid:mid + SERVE_BATCH])
            _bitwise(f"{name}: 8 rows 2 elements into a buffer vs aligned",
                     shifted, eight)
            for r in (0, mid + 3, rows - 1):
                _bitwise(f"{name}: row {r} alone vs in {rows} rows",
                         rn.rmsnorm(x[r:r + 1], st, round_inv=True)[0],
                         full[r])
            compared += 3 + 2 * SERVE_BATCH
            del x, full
    log(f"  rmsnorm's sum order by d and dtype: the same bits alone, in 8 "
        f"rows, in the prefill batch and 2 elements into a buffer at d "
        f"{', '.join(map(str, RMSNORM_WIDTHS))}, bf16 and f32 ({compared} "
        f"rows compared)")
    return compared


def misaligned_flash(torch, fa, gen):
    """bf16 q, k and v as views 8 bytes into their buffers (their rows do
    not start 16-byte aligned): the wrapper copies them and launches the
    same kernel, so the result must equal that of aligned copies bit for
    bit, and the plain version's within the bf16 check."""
    b, sq, sk, hq, hkv, dh, causal, window = MISALIGNED_CASE
    views = []
    for s, h in ((sq, hq), (sk, hkv), (sk, hkv)):
        n = b * s * h * dh
        buf = torch.randn(n + 4, generator=gen, device="cuda").bfloat16()
        views.append(buf[4:].view(b, s, h, dh))
    assert not any(fa._rows_aligned(t) for t in views)
    copies = [t.clone(memory_format=torch.contiguous_format) for t in views]
    got = fa.flash_attention(*views, causal=causal, window=window)
    want = fa.flash_attention(*copies, causal=causal, window=window)
    plain = fa.PLAIN["flash_attention"](*views, causal, window)
    torch.cuda.synchronize()
    _bitwise(f"flash_attention misaligned {MISALIGNED_CASE} vs aligned "
             f"copies", got, want)
    err = _bf16_ulp_check(torch, "flash_attention misaligned", got, plain,
                          BF16_ULPS["flash_attention"],
                          **LM_TOL["flash_attention"])
    rec = {"case": list(MISALIGNED_CASE), "dtype": "bf16",
           "bitwise_vs_aligned": True, "max_abs_err": err,
           "ms": time_ms(torch, lambda: fa.flash_attention(
               *views, causal=causal, window=window)),
           "aligned_ms": time_ms(torch, lambda: fa.flash_attention(
               *copies, causal=causal, window=window))}
    log(f"  flash bf16 {MISALIGNED_CASE} as views 8 bytes into their "
        f"buffers: bitwise equal to aligned copies, max err vs plain "
        f"{err:.3g}; {rec['ms']:.4f} ms with the copies (aligned "
        f"{rec['aligned_ms']:.4f})")
    return rec


def grad_phase(torch):
    """Phase 3e: ``backward`` through the autograd Functions of
    ``rmsnorm`` (both rounding orders, both dtypes) and
    ``flash_attention`` (Dh 64 and 96, both dtypes). Each gradient must
    exist, be finite and not all zero, and equal the plain version's own
    autograd gradient bit for bit (the Function's backward is that
    recompute)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = []
    for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        x = (torch.randn(333, 2048, generator=gen, device=dev) * 2).to(dt)
        scale = 1 + 0.1 * torch.randn(2048, generator=gen, device=dev)
        for round_inv in (False, True):
            cases.append((
                f"rmsnorm {dname} round_inv={round_inv}", (x, scale),
                lambda a, b, r=round_inv: rn.rmsnorm(a, b, round_inv=r),
                lambda a, b, r=round_inv: rn.PLAIN["rmsnorm"](a, b, 1e-5, r)))
        for dh in (64, 96):
            qkv = tuple(torch.randn(2, 300, h, dh, generator=gen, device=dev)
                        .to(dt) for h in (8, 2, 2))
            cases.append((
                f"flash_attention {dname} Dh {dh}", qkv,
                lambda a, b, c: fa.flash_attention(a, b, c, causal=True),
                lambda a, b, c: fa.PLAIN["flash_attention"](a, b, c, True,
                                                            None)))
    out = {}
    for name, inputs, fn, plain in cases:
        grads = []
        for f in (fn, plain):
            leaves = [t.detach().clone().requires_grad_() for t in inputs]
            y = f(*leaves)
            g = torch.Generator(device=dev).manual_seed(7)
            y.backward(torch.randn(y.shape, generator=g, device=dev)
                       .to(y.dtype))
            grads.append([t.grad for t in leaves])
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(*grads)):
            what = f"{name} grad of input {i}"
            if a is None or not bool(torch.isfinite(a).all()) \
                    or not bool((a != 0).any()):
                raise AssertionError(f"{what}: missing, non-finite or zero")
            _bitwise(what, a, b)
        out[name] = {"inputs": len(inputs), "bitwise": True}
    log(f"  {len(cases)} cases, every gradient present, finite, non-zero "
        f"and bitwise equal to the plain version's autograd: "
        f"{', '.join(out)}")
    return out


def lm_launches(cfg, forwards: int, prefills: int, remats: int = 0):
    """The ``flash_attention`` and ``rmsnorm`` launches of ``forwards``
    forwards of the LM ``cfg``, ``prefills`` of them over a whole
    sequence (a prefill or a training forward; the others decode steps,
    whose single query never takes flash): flash at each attention site
    (a transformer's layers; zamba2's shared blocks, one per group;
    whisper's encoder layers and its decoder's self and cross
    attention), rmsnorm at each RMSNorm site (a transformer's 2 a layer
    and the final norm; zamba2's 2 a mamba layer, 2 a shared block and
    the final norm; xLSTM's mLSTM output norms; none in a LayerNorm
    model). ``remats`` of the training forwards ran with ``remat``: the
    checkpointed layers' sites run again in their backward (a
    transformer's layer groups; zamba2's mamba layers)."""
    L = cfg.n_layers
    if cfg.family == "hybrid":
        groups = L // cfg.shared_attn_every
        return {"flash_attention": groups * prefills,
                "rmsnorm": (2 * L + 2 * groups + 1) * forwards
                + 2 * L * remats}
    if cfg.family == "ssm":
        mlstm = L // cfg.slstm_every * (cfg.slstm_every - 1)
        return {"flash_attention": 0, "rmsnorm": mlstm * forwards}
    if cfg.family == "audio":
        sites = cfg.n_encoder_layers + 2 * L
        return {"flash_attention": sites * prefills, "rmsnorm": 0}
    if remats and cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(f"remat launch counts of {cfg.family}")
    return {"flash_attention": L * (prefills + remats),
            "rmsnorm": ((2 * L + 1) * forwards + 2 * L * remats
                        if cfg.norm == "rmsnorm" else 0)}


def serve_counts_check(launches, cfg, forwards: int, prefills: int) -> None:
    """flash and rmsnorm as ``lm_launches`` says; every other kernel
    none."""
    want = {k: 0 for k in launches}
    want.update(lm_launches(cfg, forwards, prefills))
    log(f"  launches {launches} (want {want})")
    assert launches == want, (launches, want)


def serve_main_path(torch, libs, profile: bool):
    """Main path 4: ``serve()`` of llama3.2-1b at full width, 8 prompts of
    1,024 tokens, 31 greedy decode steps, bf16, chunked (flash)
    attention. The counted run goes through ``serve()`` itself; then a
    second session (``build_serve_setup`` + ``generate``, the two halves
    of ``serve()``) gives the warm call, the launches of one prefill and
    of one decode step alone, the profile and the prefill logits through
    the naive attention."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (build_serve_setup, generate,
                                          make_prompts, serve)
    from repro_torch.models import build_model
    from repro_torch.training.step import make_decode_step, make_prefill_step

    cfg = get_config("llama3.2-1b")
    bf16 = torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts(libs)
    t0 = time.perf_counter()
    first = serve(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS,
                  compute_dtype=bf16, attention_impl="chunked",
                  device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(libs)
    serve_counts_check(launches, cfg, SERVE_STEPS, 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gen = first["generated"]
    assert gen.shape == (SERVE_BATCH, SERVE_STEPS), gen.shape
    assert ((gen >= 0) & (gen < cfg.vocab_size)).all(), gen

    t0 = time.perf_counter()
    model, params = build_serve_setup(cfg, compute_dtype=bf16,
                                      attention_impl="chunked",
                                      device="cuda")
    setup_s = time.perf_counter() - t0
    prompts = make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = generate(model, params, prompts, SERVE_STEPS)
    warm_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    same = bool((warm["generated"] == gen).all())

    # one prefill and one decode step alone, their launches counted
    tokens = {"tokens": torch.from_numpy(prompts).to("cuda")}
    cache, _ = model.cache_shape(SERVE_BATCH, SERVE_PROMPT + SERVE_STEPS,
                                 bf16)
    reset_counts(libs)
    logits, cache = make_prefill_step(model)(params, cache, tokens)
    torch.cuda.synchronize()
    serve_counts_check(read_counts(libs), cfg, 1, 1)
    assert logits.shape == (SERVE_BATCH, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    step = {"tokens": torch.argmax(logits[:, -1], -1)[:, None],
            "cache_index": SERVE_PROMPT}
    reset_counts(libs)
    dlogits, cache = make_decode_step(model)(params, cache, step)
    torch.cuda.synchronize()
    serve_counts_check(read_counts(libs), cfg, 1, 0)
    assert bool(torch.isfinite(dlogits).all()), "non-finite decode logits"

    # the same prompts and weights through the naive attention
    naive = build_model(cfg, bf16, attention_impl="naive", device="cuda")
    ncache, _ = naive.cache_shape(SERVE_BATCH, SERVE_PROMPT, bf16)
    nlogits, _ = make_prefill_step(naive)(params, ncache, tokens)
    rel = ((logits.float() - nlogits.float()).norm()
           / nlogits.float().norm()).item()
    agree = (logits.argmax(-1) == nlogits.argmax(-1)).float().mean().item()
    del ncache, nlogits

    stats = {
        "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
        "decode_steps": SERVE_STEPS,
        "first": {k: first[k] for k in ("prefill_s", "decode_s",
                                        "decode_tok_per_s")},
        "first_wall_s": wall,
        "warm": {k: warm[k] for k in ("prefill_s", "decode_s",
                                      "decode_tok_per_s")},
        "prefill_ms": warm["prefill_s"] * 1e3,
        "decode_ms_per_step": warm["decode_s"] / (SERVE_STEPS - 1) * 1e3,
        "decode_tok_per_s": warm["decode_tok_per_s"],
        "peak_mem_gib": warm_peak, "first_peak_mem_gib": peak,
        "setup_s": setup_s,
        "warm_tokens_equal_first": same,
        "naive_rel_norm": rel, "naive_argmax_agree": agree,
        "launches": launches}
    log(f"  first call: prefill {first['prefill_s'] * 1e3:.2f} ms, decode "
        f"{first['decode_s'] / (SERVE_STEPS - 1) * 1e3:.2f} ms/step "
        f"({first['decode_tok_per_s']:.1f} tok/s), serve() wall "
        f"{wall:.1f}s with set-up")
    log(f"  warm call: prefill {stats['prefill_ms']:.2f} ms, decode "
        f"{stats['decode_ms_per_step']:.2f} ms/step "
        f"({stats['decode_tok_per_s']:.1f} tok/s); the same tokens as the "
        f"first call: {same}; peak {warm_peak:.2f} GiB (the first call "
        f"with its set-up {peak:.2f} GiB)")
    log(f"  prefill logits, flash vs naive attention: relative norm "
        f"{rel:.3g} (bound {NAIVE_REL_TOL}), argmax agree {agree:.3f}")
    assert rel <= NAIVE_REL_TOL, rel
    if profile:
        stats["profile"] = serve_profile(torch, model, params, tokens)
    return launches, stats


def serve_profile(torch, model, params, tokens, steps: int = 4):
    """``--profile`` (and main path 14): one prefill and ``steps`` decode
    steps under torch.profiler, each window's wall time, device busy
    time (the summed kernel time, one stream) and idle share, and its top
    kernels. Only device activity is traced: a zamba2-7b prefill runs
    ~50 k kernels and an xLSTM one ~78 k, whose host ops would take the
    profiler tens of seconds to sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training.step import make_decode_step, make_prefill_step
    prompt = tokens["tokens"].shape[1]
    cache, _ = model.cache_shape(SERVE_BATCH, prompt + steps + 1,
                                 model.compute_dtype)
    out = {}
    for phase in ("prefill", "decode"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                logits, cache = make_prefill_step(model)(params, cache,
                                                         tokens)
                n = 1
            else:
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                for i in range(steps):
                    logits, cache = make_decode_step(model)(
                        params, cache, {"tokens": tok,
                                        "cache_index": prompt + i})
                    tok = torch.argmax(logits[:, -1], -1)[:, None]
                n = steps
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        rec = {"calls": n, "wall_ms": wall / n * 1e3,
               "device_busy_ms": busy / n * 1e3,
               "device_idle_share": 1.0 - busy / wall if wall else None,
               "kernels_per_call": sum(e.count for e in kernels) / n,
               "top_kernels": [(e.key[:90], e.count // n,
                                e.self_device_time_total / n / 1e3)
                               for e in top]}
        out[phase] = rec
        log(f"  {phase} (per call, {n}): wall {rec['wall_ms']:.2f} ms, "
            f"device busy {rec['device_busy_ms']:.2f} ms (idle share "
            f"{rec['device_idle_share']:.3f}), "
            f"{rec['kernels_per_call']:.0f} kernels")
        for name, c, ms in rec["top_kernels"]:
            log(f"    device {ms:8.3f} ms x{c:4d} {name}")
    return out


def serve_reference_phase(torch, arch: str = "llama3.2-1b",
                          prompt: int = 130):
    """Phase 9b (18b: ``arch`` a MoE config, ``prompt`` a multiple of
    its dispatch group over the batch; 20b: the last four families, the
    VLM with its patches and the audio model with its frames, ``prompt``
    a multiple of the chunked GLA's 128): the reduced ``arch`` in f32 with
    the same weights on the card (the kernels) and on the CPU (their
    plain versions): prefill and 6 greedy decode steps, logits within
    rtol/atol 1e-4 (f32 sums in other orders) and the same tokens. TF32
    is off for float32 products on the card
    (``torch.backends.cuda.matmul.allow_tf32 = False``), so both sides
    multiply in full f32."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.training.step import make_decode_step, make_prefill_step

    cfg = reduced_config(get_config(arch))
    b, steps = 4, 6
    requests = make_requests(cfg, b, prompt, 7)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sides = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, torch.float32, attention_impl="chunked",
                                device=dev)
            params = model.init(7)
            cache, _ = model.cache_shape(b, prompt + steps, torch.float32)
            batch = {k: torch.from_numpy(v).to(
                dev, None if k == "tokens" else torch.float32)
                for k, v in requests.items()}
            logits, cache = make_prefill_step(model)(params, cache, batch)
            seq_logits, seq_tokens = [logits.cpu()], []
            for i in range(steps):
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                seq_tokens.append(tok.cpu())
                logits, cache = make_decode_step(model)(
                    params, cache, {"tokens": tok, "cache_index": prompt + i})
                seq_logits.append(logits.cpu())
            sides[dev] = (seq_logits, torch.cat(seq_tokens, 1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (card_l, card_t), (cpu_l, cpu_t) = sides["cuda"], sides["cpu"]
    err = max((a - c).abs().max().item() for a, c in zip(card_l, cpu_l))
    for i, (a, c) in enumerate(zip(card_l, cpu_l)):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4,
                                   msg=lambda m, i=i: f"call {i}: {m}")
    assert torch.equal(card_t, cpu_t), (card_t, cpu_t)
    log(f"  prefill + {steps} decode steps: logits within {err:.3g} "
        f"(bound rtol/atol 1e-4), greedy tokens equal "
        f"{card_t.tolist()[0]}")
    return {"max_abs_err": err, "tokens": card_t.tolist()}


# ---------------------------------------------------------------------------
# slice 13: main path 9 (the other dense configs served) and main path 10
# (LM training of llama3.2-1b), and their kernels at their shapes
# ---------------------------------------------------------------------------

# (arch, layers kept: None for the full depth, decode steps + 1) of main
# path 9: yi-9b whole (18 GB of bf16 weights), granite-34b and qwen2-72b
# at full width with their depth cut to fit beside the rest (their whole
# bf16 weights, 68 and 145 GB, do not fit an 80 GB card with a prefill's
# activations)
DENSE_SERVE = (("yi-9b", None, SERVE_STEPS), ("granite-34b", 8, 4),
               ("qwen2-72b", 4, 4))
# main path 10: llama3.2-1b trained at full width, batch 4 x 1,024 tokens
LM_TRAIN_ARCH = "llama3.2-1b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 1024, 6
# the recipe of examples/train_llm_100m.py (no weight decay: the update
# runs the _kernel body, not _kernel_wd)
LM_TRAIN_OPT = dict(kind="rmsprop_warmup", schedule="slow_start",
                    base_lr_per_256=3e-3, beta_center=1.0, beta_period=1.0,
                    weight_decay=0.0)
# phase 3f: flash_attention and rmsnorm at this slice's shapes, bf16
SLICE13_FLASH = {
    "yi-9b prefill": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 4, 128,
                      True, None),
    "granite-34b prefill": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 48, 1,
                            128, True, None),
    "qwen2-72b prefill": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 64, 8,
                          128, True, None),
    "llama3.2-1b training": (LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_SEQ, 32,
                             8, 64, True, None),
}
SLICE13_RMSNORM = {
    "yi-9b prefill": (SERVE_BATCH * SERVE_PROMPT, 4096),
    "yi-9b decode": (SERVE_BATCH, 4096),
    "qwen2-72b prefill": (SERVE_BATCH * SERVE_PROMPT, 8192),
    "qwen2-72b decode": (SERVE_BATCH, 8192),
    "llama3.2-1b training": (LM_TRAIN_BATCH * LM_TRAIN_SEQ, 2048),
}
# phase 16b: the reduced llama3.2-1b in f32 on the card against the CPU,
# losses as the DP step against JAX (rtol 2e-5), parameters by relative
# norm (2e-4; the RMSprop warm-up moves an element whose tiny gradient
# flips sign by ~lr, test_torch_slice.py)
LM_REF_LOSS_RTOL, LM_REF_PARAM_TOL = 2e-5, 2e-4


def flash_shape_cases(torch, gen, cases, dtypes=("bfloat16",)):
    """``flash_attention`` against its plain version at each case and
    dtype (the tolerances of phase 3d), timed with its plain version,
    SDPA on the same inputs (with the window as a boolean mask where
    there is one) and its bound. Returns {"<name> <dtype>": record}."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    out = {}
    for name, case in cases.items():
        b, sq, sk, hq, hkv, dh, causal, window = case
        for dt in dtypes:
            dtype = getattr(torch, dt)
            q, k, v = (torch.randn(b, s_, h, dh, generator=gen, device=dev)
                       .to(dtype) for s_, h in ((sq, hq), (sk, hkv),
                                                (sk, hkv)))
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.PLAIN["flash_attention"](q, k, v, causal, window)
            torch.cuda.synchronize()
            if dtype == torch.bfloat16:
                err = _bf16_ulp_check(torch, f"flash_attention {name}",
                                      got, want, BF16_ULPS["flash_attention"],
                                      **LM_TOL["flash_attention"])
            else:
                torch.testing.assert_close(got, want,
                                           **LM_TOL["flash_attention"])
                err = (got - want).abs().max().item()
            del got, want
            b16_ms, f32_ms, _, flops = flash_bound(case, dtype.itemsize)
            bytes_ms = (dtype.itemsize * b * dh * (2 * sq * hq + 2 * sk * hkv)
                        / HBM_BYTES_PER_S * 1e3)
            bound_ms = b16_ms if dtype == torch.bfloat16 else f32_ms
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mask = None
            if window is not None:
                qi = torch.arange(sq, device=dev)[:, None]
                kj = torch.arange(sk, device=dev)[None, :]
                mask = (kj <= qi) & (qi - kj < window)
            rec = {"case": list(case), "dtype": dt, "max_abs_err": err,
                   "ms": time_ms(torch, lambda: fa.flash_attention(
                       q, k, v, causal=causal, window=window)),
                   "plain_ms": time_ms(torch, lambda: fa.PLAIN[
                       "flash_attention"](q, k, v, causal, window), iters=3,
                       trials=3),
                   "library_ms": time_ms(
                       torch, lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, attn_mask=mask,
                           is_causal=causal and mask is None,
                           enable_gqa=True)),
                   "bound_ms": bound_ms,
                   "bound_by": "bytes" if bytes_ms >= bound_ms
                   else "operations", "flops": flops}
            out[f"{name} {dt}"] = rec
            log(f"  flash {dt} {name} {case}: {rec['ms']:.4f} ms (plain "
                f"{rec['plain_ms']:.4f}, sdpa {rec['library_ms']:.4f}, "
                f"bound {bound_ms:.4f}), max err {err:.3g}")
            del q, k, v, qt, kt, vt, mask
            torch.cuda.empty_cache()
    return out


def rmsnorm_shape_cases(torch, gen, cases):
    """``rmsnorm`` (bf16, the model's rounding order) against its plain
    version at each (rows, d), timed with its plain version,
    ``F.rms_norm`` (the same bf16 scale) and its bound; above decode
    rows also with L2 emptied before each call (``cold_ms``: graph
    replays keep inputs of up to 50 MB in L2, where the HBM bound does
    not hold)."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    out = {}
    for name, (rows, d) in cases.items():
        x = (torch.randn(rows, d, generator=gen, device=dev) * 2 + 0.3
             ).to(bf16)
        st = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(bf16)
        got = rn.rmsnorm(x, st, round_inv=True)
        want = rn.PLAIN["rmsnorm"](x, st, 1e-5, True)
        torch.cuda.synchronize()
        err = _bf16_ulp_check(torch, f"rmsnorm {name} {rows} x {d}", got,
                              want, BF16_ULPS["rmsnorm"], **LM_TOL["rmsnorm"])
        bound_ms, bound_by = bound(2 * (2 * rows * d + d), 4 * rows * d)
        rec = {"rows": rows, "d": d, "max_abs_err": err,
               "ms": time_ms(torch, lambda: rn.rmsnorm(x, st,
                                                        round_inv=True)),
               "plain_ms": time_ms(torch, lambda: rn.PLAIN["rmsnorm"](
                   x, st, 1e-5, True)),
               "library_ms": time_ms(torch, lambda: F.rms_norm(
                   x, (d,), st, 1e-5)),
               "bound_ms": bound_ms, "bound_by": bound_by}
        if rows > SERVE_BATCH:
            rec["cold_ms"] = time_cold_ms(torch, lambda: rn.rmsnorm(
                x, st, round_inv=True))
        out[name] = rmsnorm_shares(torch, rec, x, st)
        log(f"  rmsnorm bf16 {name} {rows} x {d}: {rec['ms']:.4f} ms (plain "
            f"{rec['plain_ms']:.4f}, F.rms_norm {rec['library_ms']:.4f}, "
            f"bound {bound_ms:.4f}, {rmsnorm_share_text(rec)}), max err "
            f"{err:.3g}")
        del x, got, want
    return out


def tree_update_cast(torch, gen, cfg):
    """``hybrid_update`` over ``cfg``'s f32 leaves (drawn on the card) in
    one launch, the gradients as views into one stream as unpack gives
    them, bitwise per leaf against the plain version (a_sgd 0 and 1),
    timed against the per-leaf plain version and its bound; then
    ``cast_copy`` at that gradient stream (``cast_phase``)."""
    from repro_torch.core.optimizer import HybridHyper
    from repro_torch.kernels import fused_update as fu
    from repro_torch.models.transformer import TransformerLM
    dev = torch.device("cuda")
    model = TransformerLM(cfg, device="cuda")
    params = model.init(0, draw_device="cuda")
    names = list(params)
    sizes = [params[k].numel() for k in names]
    total = sum(sizes)
    stream = torch.randn(total, generator=gen, device=dev) * 1e-3
    gs, lo = [], 0
    for n in sizes:
        gs.append(stream[lo:lo + n])
        lo += n
    ps = [params.pop(k).reshape(-1) for k in names]
    del params, model
    ds = [torch.randn(n, generator=gen, device=dev) * 1e-3 for n in sizes]
    ms = [torch.rand(n, generator=gen, device=dev) * 1e-6 for n in sizes]
    wds = [0.0] * len(sizes)
    for a_sgd in (0.0, 1.0):
        h = HybridHyper(eta=0.1, alpha_sgd=a_sgd)
        kern = [[t.clone() for t in ts] for ts in (ps, ds, ms)]
        fu.reset_launch_counts()
        fu.fused_hybrid_update_leaves(gs, *kern, h, wds)
        assert fu.LAUNCHES["hybrid_update"] == 1, fu.LAUNCHES
        for i, g in enumerate(gs):
            plain = [t[i].clone() for t in (ps, ds, ms)]
            fu.PLAIN["hybrid_update"](g, *plain, h, 0.0)
            for what, a, b in zip(("theta", "delta", "m"),
                                  (kern[0][i], kern[1][i], kern[2][i]),
                                  plain):
                _bitwise(f"hybrid_update_leaves {names[i]} a_sgd={a_sgd} "
                         f"{what}", a, b)
            del plain
        del kern
    h = HybridHyper(eta=0.1, alpha_sgd=0.0)

    def plain_all():
        for i, g in enumerate(gs):
            fu.PLAIN["hybrid_update"](g, ps[i], ds[i], ms[i], h, 0.0)

    upd = {"arch": cfg.name, "n_layers": cfg.n_layers, "leaves": len(sizes),
           "elements": total, "max_abs_err": 0.0,
           "ms": time_ms(torch, lambda: fu.fused_hybrid_update_leaves(
               gs, ps, ds, ms, h, wds), iters=3, trials=3),
           "plain_ms": time_ms(torch, plain_all, iters=2, trials=3),
           "library_ms": None}
    upd["bound_ms"], upd["bound_by"] = bound(28 * total,
                                             UPDATE_FLOPS * total)
    log(f"  hybrid_update over {cfg.name}'s ({cfg.n_layers} layers) "
        f"{len(sizes)} leaves ({total} elements) in one launch, bitwise per "
        f"leaf x a_sgd 0/1: {upd['ms']:.3f} ms (plain {upd['plain_ms']:.3f}, "
        f"bound {upd['bound_ms']:.3f})")
    del gs, ps, ds, ms, stream
    torch.cuda.empty_cache()
    cast = cast_phase(torch, total, sizes)
    cast["elements"] = total
    torch.cuda.empty_cache()
    return upd, cast


def slice13_kernel_phase(torch):
    """Phase 3f: the four kernels of this slice's paths at their shapes.
    ``flash_attention`` (bf16) at the three configs' prefills and
    llama3.2-1b's training batch, and ``rmsnorm`` (bf16, the model's
    rounding order) at yi-9b's and qwen2-72b's prefill and decode rows
    and the training batch's rows, each against its plain version (the
    tolerances of phase 3d) and timed with its library call and bound;
    ``hybrid_update`` over llama3.2-1b's 11 f32 leaves in one launch,
    bitwise per leaf (a_sgd 0 and 1), timed against the per-leaf plain
    version and its bound; ``cast_copy`` at llama3.2-1b's gradient
    stream (``cast_phase``)."""
    from repro_torch.configs import get_config
    gen = torch.Generator(device="cuda").manual_seed(13)
    flash = flash_shape_cases(torch, gen, SLICE13_FLASH)
    out = {"flash_attention": {k[:-len(" bfloat16")]: v
                               for k, v in flash.items()},
           "rmsnorm": rmsnorm_shape_cases(torch, gen, SLICE13_RMSNORM)}
    out["hybrid_update"], out["cast_copy"] = tree_update_cast(
        torch, gen, get_config(LM_TRAIN_ARCH))
    return out


class RouteTape:
    """Stands in for ``layers._route``, the routing inside ``moe_apply``:
    records each call's dispatch one-hots, in call order, or (``replay``:
    another tape) routes each call as the recorded one did (its experts
    and slots, capacity drops included), with the gates of this call's
    own router probabilities, and counts the tokens whose own choice of
    experts differs from the recorded one."""

    def __init__(self, route, replay=None):
        self.route, self.replay = route, replay
        self.calls, self.flipped, self.tokens = [], 0, 0

    def __call__(self, probs, k, cap, dt):
        dispatch, gates = self.route(probs, k, cap, dt)
        if self.replay is None:
            self.calls.append(dispatch)
            return dispatch, gates
        rec = self.replay.calls[len(self.calls)]
        self.calls.append(None)
        kept = rec.bool().any(-1)  # (groups, tokens, experts)
        self.flipped += int((kept != dispatch.bool().any(-1)).any(-1).sum())
        self.tokens += probs.shape[0] * probs.shape[1]
        return rec, probs * kept


def taped_prefill(model, params, tokens, prompt: int, replay=None):
    """One prefill of ``model`` on a fresh cache with ``moe_apply``'s
    routing recorded (or replayed: ``RouteTape``). Returns (logits,
    tape)."""
    from repro_torch.models import layers
    from repro_torch.training.step import make_prefill_step
    cache, _ = model.cache_shape(SERVE_BATCH, prompt, model.compute_dtype)
    tape = RouteTape(layers._route, replay)
    layers._route = tape
    try:
        logits, _ = make_prefill_step(model)(params, cache, tokens)
    finally:
        layers._route = tape.route
    return logits, tape


def lm_serve_path(torch, libs, arch: str, layers, steps: int,
                  prompt: int = SERVE_PROMPT, naive: bool = True,
                  profile: bool = False):
    """Main path 9 (and 12, 14), one config: ``serve()`` at full width
    (``layers`` None: full depth too) of 8 prompts of ``prompt`` tokens
    (with a VLM's patches, an audio model's frames) and ``steps - 1``
    greedy decode steps, bf16, chunked (flash) attention, the weights
    drawn on the card (``draw_device="cuda"``); then a second session
    (the warm call), one prefill and one decode step alone with their
    launches counted, with ``naive`` the prefill logits against the
    naive attention's, as main path 4, and with ``profile`` one prefill
    and 4 decode steps under torch.profiler (``serve_profile``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (build_serve_setup, generate,
                                          make_requests, serve)
    from repro_torch.models import build_model
    from repro_torch.training.step import make_decode_step, make_prefill_step

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    bf16, L = torch.bfloat16, cfg.n_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts(libs)
    t0 = time.perf_counter()
    first = serve(cfg, SERVE_BATCH, prompt, steps, compute_dtype=bf16,
                  attention_impl="chunked", device="cuda",
                  draw_device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(libs)
    serve_counts_check(launches, cfg, steps, 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gen = first["generated"]
    assert gen.shape == (SERVE_BATCH, steps), gen.shape
    assert ((gen >= 0) & (gen < cfg.vocab_size)).all(), gen

    t0 = time.perf_counter()
    model, params = build_serve_setup(cfg, compute_dtype=bf16,
                                      attention_impl="chunked",
                                      device="cuda", draw_device="cuda")
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.values())
    requests = make_requests(cfg, SERVE_BATCH, prompt)
    prompts = requests.pop("tokens")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = generate(model, params, prompts, steps, requests)
    warm_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    same = bool((warm["generated"] == gen).all())

    tokens = {"tokens": torch.from_numpy(prompts).to("cuda")}
    tokens.update({k: torch.from_numpy(v).to("cuda", bf16)
                   for k, v in requests.items()})
    cache, _ = model.cache_shape(SERVE_BATCH, prompt + steps, bf16)
    # the attention cache's length (None: a recurrent state only)
    ring = next((v.shape[2] for k, v in cache.items() if k.endswith("k")),
                None)
    reset_counts(libs)
    logits, cache = make_prefill_step(model)(params, cache, tokens)
    torch.cuda.synchronize()
    serve_counts_check(read_counts(libs), cfg, 1, 1)
    assert logits.shape == (SERVE_BATCH, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    step = {"tokens": torch.argmax(logits[:, -1], -1)[:, None],
            "cache_index": prompt}
    reset_counts(libs)
    dlogits, cache = make_decode_step(model)(params, cache, step)
    torch.cuda.synchronize()
    serve_counts_check(read_counts(libs), cfg, 1, 0)
    assert bool(torch.isfinite(dlogits).all()), "non-finite decode logits"
    del cache, dlogits

    rel = agree = routed = None
    if naive:
        nmodel = build_model(cfg, bf16, attention_impl="naive",
                             device="cuda")
        nlogits, ntape = taped_prefill(nmodel, params, tokens, prompt)

        def rel_norm(got):
            return ((got.float() - nlogits.float()).norm()
                    / nlogits.float().norm()).item()

        def argmax_agree(got):
            return (got.argmax(-1) == nlogits.argmax(-1)).float().mean(
                ).item()

        rel, agree = rel_norm(logits), argmax_agree(logits)
        if cfg.n_experts:
            # a token near a tie between two experts may route otherwise
            # under either attention: the check holds flash to naive
            # with the naive prefill's routing replayed
            plogits, tape = taped_prefill(model, params, tokens, prompt,
                                          replay=ntape)
            routed = {"free_rel_norm": rel, "free_argmax_agree": agree,
                      "flipped_tokens": tape.flipped,
                      "routed_tokens": tape.tokens}
            rel, agree = rel_norm(plogits), argmax_agree(plogits)
            del plogits, tape
        del nlogits, ntape
    prof = serve_profile(torch, model, params, tokens) if profile else None
    del logits, params, model
    torch.cuda.empty_cache()
    stats = {
        "arch": arch, "n_layers": L, "full_depth": layers is None,
        "parameters": n_params, "batch": SERVE_BATCH,
        "prompt_len": prompt, "decode_steps": steps, "cache_len": ring,
        "frontend": {k: list(v.shape) for k, v in requests.items()},
        "first": {k: first[k] for k in ("prefill_s", "decode_s",
                                        "decode_tok_per_s")},
        "first_wall_s": wall, "setup_s": setup_s,
        "prefill_ms": warm["prefill_s"] * 1e3,
        "decode_ms_per_step": warm["decode_s"] / max(steps - 1, 1) * 1e3,
        "decode_tok_per_s": warm["decode_tok_per_s"],
        "peak_mem_gib": warm_peak, "first_peak_mem_gib": peak,
        "warm_tokens_equal_first": same,
        "naive_rel_norm": rel, "naive_argmax_agree": agree,
        "naive_routing": routed, "launches": launches}
    if prof is not None:
        stats["profile"] = prof
    log(f"  {arch} ({L} layers, {n_params} parameters, bf16): first call "
        f"prefill {first['prefill_s'] * 1e3:.2f} ms, serve() wall "
        f"{wall:.1f}s with set-up; warm call prefill "
        f"{stats['prefill_ms']:.2f} ms, decode "
        f"{stats['decode_ms_per_step']:.2f} ms/step "
        f"({stats['decode_tok_per_s']:.1f} tok/s), same tokens {same}; "
        f"peak {warm_peak:.2f} GiB (first call {peak:.2f}); set-up "
        f"{setup_s:.1f}s")
    if routed:
        log(f"  {arch} prefill logits, flash vs naive attention, each "
            f"routing its own tokens: relative norm "
            f"{routed['free_rel_norm']:.3g}; {routed['flipped_tokens']} of "
            f"{routed['routed_tokens']} token routings (all MoE layers) "
            f"differ")
    if naive:
        log(f"  {arch} prefill logits, flash vs naive attention"
            f"{', the naive routing replayed' if routed else ''}: relative "
            f"norm {rel:.3g} (bound {NAIVE_REL_TOL}), argmax agree "
            f"{agree:.3f}")
        assert rel <= NAIVE_REL_TOL, (arch, rel)
    return launches, stats


def lm_train_run(torch, libs, cfg, dp: bool, steps: int, build=None):
    """``steps`` steps of main path 10 (or 11, 13: ``cfg``, ``build``)
    and one eval batch through the ``Trainer``: llama3.2-1b at full
    width (its weights drawn on the card from seed 0), batch 4 x 1,024
    tokens, bf16, flash attention, rmsprop_warmup + slow_start through
    the fused update; on one device with the bf16 wire cast, or
    (``dp``) the DP step at world size 1 over NCCL with the bucketed
    bf16 all-reduce (``build``: more ``build_train_setup`` options, such
    as ``overlap_comm``). The kernel counts are set to 0 just before
    the run. Returns (result, launches, stats, (train_step, data))."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch.train import build_eval_setup, build_train_setup
    from repro_torch.training import Trainer, TrainerConfig

    t0 = time.perf_counter()
    mode = "shardmap" if dp else "none"
    model, state, train_step, data, put, shardings = build_train_setup(
        cfg, global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
        opt_cfg=OptimizerConfig(**LM_TRAIN_OPT), steps_per_epoch=steps,
        dp_mode=mode, compute_dtype=torch.bfloat16,
        attention_impl="chunked", use_fused_kernel=True,
        compression="bf16+bucketed" if dp else "bf16", draw_device="cuda",
        device="cuda", **(build or {}))
    ev, vd, fin = build_eval_setup(model, cfg, global_batch=LM_TRAIN_BATCH,
                                   seq_len=LM_TRAIN_SEQ, dp_mode=mode)
    setup_s = time.perf_counter() - t0
    tcfg = TrainerConfig(epochs=1, steps_per_epoch=steps,
                         eval_every_epochs=1, val_batches=1, log_every=1)
    trainer = Trainer(train_step, state, data, tcfg, eval_step=ev,
                      val_data=vd, finalize_state=fin, put_batch=put,
                      state_shardings=shardings)
    del state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(libs)
    t0 = time.perf_counter()
    result = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(libs)
    losses = [h["loss"] for h in result.history]
    assert len(losses) == steps and all(math.isfinite(v) for v in losses), \
        losses
    ev_rec = result.epoch_history[-1]
    assert math.isfinite(ev_rec["loss"]) and "top1" not in ev_rec, ev_rec
    forwards = steps + tcfg.val_batches
    # the overlapped step casts each segment's gradients as it packs
    # them, and the synced stream back once
    casts = (len(model.segment_names()) + 1 if (build or {}).get(
        "overlap_comm") else 2 if dp else 0)
    want = {k: 0 for k in launches}
    remat = (build or {}).get("remat", cfg.n_layers > 8)
    want.update(lm_launches(cfg, forwards, forwards,
                            steps if remat else 0))
    want.update(hybrid_update=steps, cast_copy=casts * steps)
    log(f"  {'DP step' if dp else 'one device'}: losses {losses}, eval "
        f"loss {ev_rec['loss']:.4f}; launches {launches} (want {want})")
    assert launches == want, (launches, want)
    step_ms = [h["time"] * 1e3 for h in result.history[1:]]
    med = statistics.median(step_ms)
    n_params = sum(p.numel() for p in result.state["params"].values())
    stats = {"dp": dp, "steps": steps, "remat": remat, "setup_s": setup_s,
             "run_s": wall,
             "parameters": n_params, "losses": losses,
             "eval_loss": ev_rec["loss"], "median_step_ms": med,
             "step_ms": step_ms,
             "first_step_ms": result.history[0]["time"] * 1e3,
             "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / med * 1e3,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": launches}
    log(f"  median step {med:.2f} ms ({stats['tokens_per_s']:.0f} "
        f"tokens/s), first step {stats['first_step_ms']:.0f} ms, peak "
        f"{stats['peak_mem_gib']:.2f} GiB, set-up {setup_s:.1f}s, "
        f"{n_params} parameters")
    return result, launches, stats, (train_step, data)


def lm_train_path(torch, libs, profile: bool):
    """Main path 10: llama3.2-1b trained at full width (``lm_train_run``)
    on one device, then through the DP step at world size 1 over NCCL,
    whose state after the steps must be bitwise the one-device run's
    (losses, parameters, ``delta``, ``m``, ``opt.step``). Both run with
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: the
    backward of the token lookup adds rows of the embedding gradient
    with atomics otherwise, in no fixed order. With ``profile``, two
    more one-device steps under torch.profiler."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import shutdown

    cfg = get_config(LM_TRAIN_ARCH)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    prof = None
    try:
        r1, launches, stats1, live = lm_train_run(torch, libs, cfg, False,
                                                  LM_TRAIN_STEPS)
        r2, launches_dp, stats2, _ = lm_train_run(torch, libs, cfg, True,
                                                  LM_TRAIN_STEPS)
        s1, s2 = r1.state, r2.state
        entries = state_entries(s1)
        differ = bits_differ(torch, entries, state_entries(s2))
        same_losses = [h["loss"] for h in r1.history] == \
            [h["loss"] for h in r2.history]
        log(f"  DP step at world size 1 vs one device: losses equal "
            f"{same_losses}, {len(differ)} of {len(entries)} state entries "
            f"differ {differ[:6]}")
        assert same_losses and not differ, differ
        del r2, s2
        if profile:
            log("[16p] profile of main path 10 (one device, 2 more steps)")
            prof = profile_phase(torch, live[0], s1, live[1], steps=2)
    finally:
        shutdown()
        torch.use_deterministic_algorithms(was)
    ref = ([h["loss"] for h in r1.history], s1)  # main path 11's yardstick
    del r1, live
    torch.cuda.empty_cache()
    out = {"one_device": stats1, "dp": stats2, "dp_bitwise": True}
    if prof is not None:
        out["profile"] = prof
    return launches, launches_dp, out, ref


def lm_train_reference_phase(torch):
    """Phase 16b: the reduced llama3.2-1b in f32 trained 3 steps on the
    card (the kernels) and on the CPU (their plain versions) from the
    same weights and batches (batch 2 x 256 tokens, flash attention, the
    recipe of main path 10): losses within rtol ``LM_REF_LOSS_RTOL``,
    parameters within a relative norm of ``LM_REF_PARAM_TOL``. TF32 is
    off on the card."""
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.configs import reduced_config
    from repro_torch.launch.train import build_train_setup

    cfg = reduced_config(get_config(LM_TRAIN_ARCH))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sides = {}
        for dev in ("cuda", "cpu"):
            _, s, step, data, _, _ = build_train_setup(
                cfg, global_batch=2, seq_len=256,
                opt_cfg=OptimizerConfig(**LM_TRAIN_OPT), steps_per_epoch=4,
                attention_impl="chunked", use_fused_kernel=True, device=dev)
            losses = []
            for i in range(3):
                s, met = step(s, data.batch_at(i))
                losses.append(float(met["loss"]))
            sides[dev] = (losses, {k: v.cpu() for k, v in
                                   s["params"].items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (cl, cp), (hl, hp) = sides["cuda"], sides["cpu"]
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(cl, hl))
    rel_p = param_rel_norm(cp, hp)
    log(f"  3 steps: losses card {cl} vs CPU {hl} (largest relative "
        f"difference {rel_loss:.3g}, bound {LM_REF_LOSS_RTOL}); parameters "
        f"{rel_p:.3g} apart in relative norm (bound {LM_REF_PARAM_TOL})")
    assert rel_loss <= LM_REF_LOSS_RTOL and rel_p <= LM_REF_PARAM_TOL, \
        (rel_loss, rel_p)
    return {"losses_card": cl, "losses_cpu": hl, "loss_rel": rel_loss,
            "param_rel_norm": rel_p}


# ---------------------------------------------------------------------------
# slice 14: main path 11 (the LM on the overlapped, ZeRO and hierarchical
# DP steps), main path 12 (the MoE family served), main path 13 (MoE
# training), and their kernels at their shapes
# ---------------------------------------------------------------------------

# phase 3f, extended: flash_attention in both dtypes at mixtral's window
# (4,096, keys past it) and maverick's GQA group of 5; rmsnorm at their
# widths
SLICE14_FLASH = {
    "mixtral-8x7b prefill past the window": (1, 5120, 5120, 32, 8, 128,
                                             True, 4096),
    "llama4-maverick prefill": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 40,
                                8, 128, True, None),
}
# and flash_attention in bf16 (the dtype they run) at main paths 12 and
# 13's own mixtral shapes: the prefills of 1,024 and 4,064 tokens (4,064
# is no multiple of the kernel's 64-row tiles: the tail tiles; batch 4,
# not the path's 8, so that the plain version's f32 scores fit beside
# the kernel's inputs) and the training forward
SLICE14_PATH_FLASH = {
    "mixtral-8x7b prefill": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32,
                             8, 128, True, 4096),
    "mixtral-8x7b prefill of 4,064": (4, 4064, 4064, 32, 8, 128, True,
                                      4096),
    "mixtral-8x7b training": (LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_SEQ,
                              32, 8, 128, True, 4096),
}
SLICE14_RMSNORM = {
    "mixtral-8x7b prefill": (SERVE_BATCH * SERVE_PROMPT, 4096),
    "mixtral-8x7b prefill of 4,064": (SERVE_BATCH * 4064, 4096),
    "mixtral-8x7b decode": (SERVE_BATCH, 4096),
    "mixtral-8x7b training": (LM_TRAIN_BATCH * LM_TRAIN_SEQ, 4096),
    "llama4-maverick prefill": (SERVE_BATCH * SERVE_PROMPT, 5120),
    "llama4-maverick decode": (SERVE_BATCH, 5120),
}
# main path 11: llama3.2-1b (main path 10's recipe) on the other DP
# steps. Over gloo, processes sharing the one card each hold a worker's
# whole state and activations (~13.5 GB beside ~1.5 GB a layer at 4 x
# 1,024 tokens, from main path 10's 46.57 GiB at 16 layers on an
# NVIDIA H100 80GB HBM3 at 700 W), so the multi-process runs keep 2
# layers (the 2-process runs kept 4 until PR 29, which cut them to make
# room for main paths 20 and 21)
LM_DP_LAYERS = {2: 2, 4: 2}
# one step at full width (gloo sums a worker's ~0.8-1 GB of bf16
# gradients on the host: 2.6-9.4 s a step on that card), three on the
# reduced model
LM_DP_STEPS, LM_DP_REDUCED_STEPS = 1, 3
# workers -> run -> build options; the last run of each is the
# bucketed step, which every other run must equal bitwise. The four
# processes run first, as a 2x2 layout; then two of them as two workers
LM_DP_RUNS = {
    4: {"zero_hier": dict(zero_dp=True, **HIER_BUILD),
        "bucketed_hier": dict(HIER_BUILD)},
    2: {"zero": dict(zero_dp=True), "bucketed": {}}}
# 17b, the reduced model in f32 in the same processes: run -> options
LM_DP_REDUCED = {
    4: {"overlap_hier": dict(overlap_comm=True, **HIER_BUILD),
        "zero_hier": dict(zero_dp=True, **HIER_BUILD),
        "zero_overlap_hier": dict(zero_dp=True, overlap_comm=True,
                                  **HIER_BUILD),
        "bucketed_hier": dict(HIER_BUILD)},
    2: {"overlap": dict(overlap_comm=True), "zero": dict(zero_dp=True),
        "zero_overlap": dict(zero_dp=True, overlap_comm=True),
        "bucketed": {}}}
LM_DP_SMALL_BUCKET = 64 * 1024  # 17b: a few dozen buckets
# the staged LM loss against loss_fn: the tied table's two contributions
# may sum in another order (the JAX package's own pair: 1.19e-7)
STAGED_TABLE_ATOL = 2.4e-7
# main path 12: (arch, layers kept, prompt, decode steps + 1, naive check)
# mixtral-8x7b's 93 GB of bf16 weights do not fit the card: 8 of its 32
# layers; maverick at one layer group of its 24 (a dense and a MoE layer
# with 128 experts and the shared expert, ~36.7 GB in bf16); then
# mixtral with a prompt of 4,064 tokens and 64 decode steps, which
# crosses the 4,096-token window during decode, the ring wrapping (its
# naive prefill would hold 17 GB of scores: not run)
MOE_SERVE = (("mixtral-8x7b", 8, SERVE_PROMPT, SERVE_STEPS, True),
             ("llama4-maverick-400b-a17b", 2, SERVE_PROMPT, 4, True),
             ("mixtral-8x7b", 8, 4064, 65, False))
# main path 13: mixtral-8x7b trained at full width, 1 of 32 layers
# (~1.71 B parameters at ~20 bytes each on the DP step; 2 layers would
# not fit), main path 10's batch and recipe (``family_train_path``)
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "mixtral-8x7b", 1


def slice14_kernel_phase(torch):
    """Phase 3f, extended: ``flash_attention`` in bf16 and f32 at
    mixtral-8x7b's windowed prefill (32 / 8 heads, Dh 128, window 4,096,
    5,120 keys) and llama4-maverick's (40 / 8 heads: a GQA group of 5),
    and in bf16 at main paths 12 and 13's mixtral shapes; ``rmsnorm`` at
    d 4,096 and 5,120 at those paths' rows; each against its plain
    version and timed with its library call and bound; ``hybrid_update``
    and ``cast_copy`` at main path 13's leaves (mixtral-8x7b, 1
    layer)."""
    import dataclasses

    from repro_torch.configs import get_config
    gen = torch.Generator(device="cuda").manual_seed(14)
    flash = flash_shape_cases(torch, gen, SLICE14_FLASH,
                              ("bfloat16", "float32"))
    flash.update(flash_shape_cases(torch, gen, SLICE14_PATH_FLASH))
    out = {"flash_attention": flash,
           "rmsnorm": rmsnorm_shape_cases(torch, gen, SLICE14_RMSNORM)}
    cfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    out["hybrid_update"], out["cast_copy"] = tree_update_cast(torch, gen,
                                                              cfg)
    return out


def lm_overlap_path(torch, libs, ref):
    """Main path 11 at world size 1: main path 10's DP step with
    ``overlap_comm=True`` (its staged loss: embed, 4 layer segments,
    head), llama3.2-1b at full width and depth, 6 steps and one eval
    batch through the ``Trainer`` over NCCL; bitwise main path 10
    (``ref``: its losses and the one-device state, which its DP step
    equals bitwise): losses, parameters, ``delta``, ``m``,
    ``opt.step``. Deterministic algorithms on, as path 10."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import shutdown

    cfg = get_config(LM_TRAIN_ARCH)
    ref_losses, s_ref = ref
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        r, launches, stats, _ = lm_train_run(
            torch, libs, cfg, True, LM_TRAIN_STEPS,
            build={"overlap_comm": True})
    finally:
        shutdown()
        torch.use_deterministic_algorithms(was)
    entries = state_entries(s_ref)
    differ = bits_differ(torch, entries, state_entries(r.state))
    losses = [h["loss"] for h in r.history]
    log(f"  overlapped vs main path 10: losses equal "
        f"{losses == ref_losses}, {len(differ)} of {len(entries)} state "
        f"entries differ {differ[:6]}")
    assert losses == ref_losses and not differ, differ
    del r, entries
    torch.cuda.empty_cache()
    return launches, stats


def lm_dp_runs(torch, libs, rank: int, n: int, full: bool):
    """Phase 17 (``full``: llama3.2-1b at full width, ``LM_DP_LAYERS[n]``
    layers, bf16, flash; else 17b: the reduced model in f32, 64 KiB
    buckets) in one of ``n`` workers: each run of ``LM_DP_RUNS[n]`` (17b:
    ``LM_DP_REDUCED``) ``LM_DP_STEPS`` steps (17b:
    ``LM_DP_REDUCED_STEPS``) from the same seed, batch 4 x 1,024 tokens a
    worker (17b: 2 x 256), and each run bitwise the last one (the
    bucketed step at this worker count): losses (a ZeRO run's under a
    hierarchy within 2.4e-7), parameters, ``opt.step`` and the optimizer
    state (``train_state_bits``; a ZeRO run's shard against the same
    shard of the bucketed state, ``zero_bits``); launches a step. Each
    earlier run's bits wait on the host until the bucketed run's state
    exists to compare them with."""
    import dataclasses

    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.configs import reduced_config
    from repro_torch.launch.train import build_train_setup

    cfg = get_config(LM_TRAIN_ARCH)
    if full:
        cfg = dataclasses.replace(cfg, n_layers=LM_DP_LAYERS[n])
        runs, batch, seq, dtype = (LM_DP_RUNS[n], LM_TRAIN_BATCH,
                                   LM_TRAIN_SEQ, torch.bfloat16)
        steps, extra = LM_DP_STEPS, {}
    else:
        cfg = reduced_config(cfg)
        runs, batch, seq, dtype = LM_DP_REDUCED[n], 2, 256, torch.float32
        steps = LM_DP_REDUCED_STEPS
        extra = {"bucket_bytes": LM_DP_SMALL_BUCKET}
    out, kept = {}, {}
    for name, build in runs.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, s, step, data, put, sh = build_train_setup(
            cfg, global_batch=batch * n, seq_len=seq,
            opt_cfg=OptimizerConfig(**LM_TRAIN_OPT),
            steps_per_epoch=steps, dp_mode="shardmap",
            compute_dtype=dtype, attention_impl="chunked",
            use_fused_kernel=True, compression="bf16+bucketed",
            draw_device="cuda", device="cuda", **build, **extra)
        rec = {"setup_s": time.perf_counter() - t0}
        reset_counts(libs)
        losses, times = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            s, met = step(s, data.batch_at(i))
            losses.append(float(met["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        rec.update(losses=losses, step_ms=times, launches=read_counts(libs),
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        out[name] = rec
        t0 = time.perf_counter()
        if len(out) < len(runs):
            plan = sh.zero_plan if build.get("zero_dp") else None
            bits = (train_state_bits(s) if plan is None
                    else zero_bits(torch, s, plan, n, rank))
            kept[name] = (plan, {k: v if k == "opt/step" else v.cpu()
                                 for k, v in bits.items()})
            del bits
        else:  # the bucketed step: every earlier run against it
            rec["n_differ"], rec["differ"] = 0, []
            for other, (plan, bits) in kept.items():
                want = (state_entries(s) if plan is None
                        else zero_bits(torch, s, plan, n, rank))
                differ = zero_differ(torch, bits, want)
                out[other]["n_differ"] = len(differ)
                out[other]["differ"] = differ[:8]
                out[other]["loss_rel"] = max(
                    abs(a - b) / abs(b)
                    for a, b in zip(out[other]["losses"], losses))
                del want
        rec["bits_s"] = time.perf_counter() - t0
        del s, step, data, put, sh
    return out


def lm_dp_cards_worker(rank: int, out_dir: str) -> None:
    """One of phase 17's processes, all on the one card: the four joined
    over gloo as a 2x2 layout, then ranks 0 and 1 as two workers (the
    others leave), each group with its full-width runs and the reduced
    ones (17b), deterministic algorithms on. Writes
    ``rank{rank}_w{n}.json`` for each group."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import shutdown
    from repro_torch.kernels import bucket_ops as bo
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_bn as fb
    from repro_torch.kernels import fused_input as fi
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import rmsnorm as rn
    libs = (fb, fu, bo, fi, fa, rn)

    torch.cuda.set_device(0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for n in LM_DP_RUNS:
        if rank >= n:
            break
        dist.init_process_group("gloo",
                                init_method=f"file://{out_dir}/store{n}",
                                rank=rank, world_size=n)
        try:
            t0 = time.perf_counter()
            out = {"full": lm_dp_runs(torch, libs, rank, n, True)}
            out["full_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["reduced"] = lm_dp_runs(torch, libs, rank, n, False)
            out["reduced_s"] = time.perf_counter() - t0
            with open(os.path.join(out_dir, f"rank{rank}_w{n}.json"),
                      "w") as f:
                json.dump(out, f)
            # the card's memory free before the smaller group starts
            torch.cuda.empty_cache()
            dist.barrier()
        finally:
            shutdown()


def lm_dp_phase(torch):
    """Phases 17 (multi-process) and 17b: four processes on the card,
    spawned once, as a 2x2 layout under ``hier:1`` (ZeRO + hier against
    bucketed + hier), then two of them over gloo (ZeRO against the
    bucketed step at 2 workers); in each group, the reduced model in f32
    (overlap, ZeRO, ZeRO + overlap against bucketed). Every run bitwise
    its bucketed counterpart (``lm_dp_runs``); launches a step as main
    path 10's DP step. Returns {workers: every rank's record}."""
    import shutil
    import tempfile


    out = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_lm_dp_")
    try:
        t0 = time.perf_counter()
        spawn(lm_dp_cards_worker, args=(root,), nprocs=max(LM_DP_RUNS))
        spawn_s = time.perf_counter() - t0
        for n in LM_DP_RUNS:
            out[n] = []
            for r in range(n):
                with open(os.path.join(root, f"rank{r}_w{n}.json")) as f:
                    out[n].append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for n, ranks in out.items():
        layers = LM_DP_LAYERS[n]
        for r, rec in enumerate(ranks):
            for part in ("full", "reduced"):
                for name, run in rec[part].items():
                    zero_hier = name.startswith("zero") and n == 4
                    log(f"  {n} workers, worker {r}, {part} {name}: losses "
                        f"{run['losses']}, {run['n_differ']} state entries "
                        f"differ from the bucketed run {run['differ'][:4]}; "
                        f"step ms {[round(t, 1) for t in run['step_ms']]}, "
                        f"set-up {run['setup_s']:.1f}s, bits "
                        f"{run['bits_s']:.1f}s, peak {run['peak_gib']:.2f} "
                        f"GiB")
                    assert not run["n_differ"], (n, part, name, run["differ"])
                    if "loss_rel" in run:
                        assert run["loss_rel"] <= (
                            HIER_LOSS_RTOL_ZERO if zero_hier else 0.0), run
            for name, run in rec["full"].items():
                want = {k: 0 for k in run["launches"]}
                want.update(flash_attention=layers * LM_DP_STEPS,
                            rmsnorm=(2 * layers + 1) * LM_DP_STEPS,
                            hybrid_update=LM_DP_STEPS)
                got = dict(run["launches"])
                # 2 casts a step (pack, unpack); the overlapped ZeRO step
                # one a segment (embed, the layer slices, head)
                casts = got.pop("cast_copy")
                want.pop("cast_copy")
                segs = 2 + min(4, layers)
                assert casts == LM_DP_STEPS * (segs + 1 if "overlap" in name
                                               else 2), (name, casts)
                assert got == want, (name, got, want)
        log(f"  {n} workers ({layers} layers full width): worker 0 seconds "
            f"full {ranks[0]['full_s']:.1f}, reduced "
            f"{ranks[0]['reduced_s']:.1f}")
    log(f"  {spawn_s:.1f}s with the spawn")
    return out


def staged_reference_phase(torch):
    """Phase 17b in this process: the staged LM loss on the card, the
    reduced llama3.2-1b (tied) and llama4-maverick (MoE groups) in f32
    with every kernel: ``staged_value_and_grad(loss_segments)`` against
    ``loss_fn``'s gradients, the loss and every gradient bitwise (the
    tied table within ``STAGED_TABLE_ATOL``)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.common import staged_value_and_grad
    from repro_torch.models.transformer import TransformerLM

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    try:
        for arch in ("llama3.2-1b", "llama4-maverick-400b-a17b"):
            cfg = reduced_config(get_config(arch))
            model = TransformerLM(cfg, torch.float32,
                                  attention_impl="chunked", device="cuda")
            params = model.init(3)
            toks = torch.from_numpy(make_prompts(cfg, 2, 257, 3)).to("cuda")
            batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
            pc = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
            total, _ = model.loss_fn(pc, {}, batch, 0.1)
            g1 = dict(zip(pc, torch.autograd.grad(total, list(pc.values()))))
            pc = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
            loss, _, g2 = staged_value_and_grad(
                model.loss_segments(pc, {}, batch, 0.1))
            table = 0.0
            for k in g1:
                if k == "embed/table" and cfg.tie_embeddings:
                    table = (g1[k] - g2[k]).abs().max().item()
                    assert table <= STAGED_TABLE_ATOL, table
                else:
                    assert torch.equal(g1[k], g2[k]), (arch, k)
            assert float(total.detach()) == float(loss.detach())
            out[arch] = {"segments": list(model.segment_names()),
                         "loss": float(loss.detach()),
                         "tied_table_max_abs": table}
            log(f"  {arch} (reduced, f32): staged loss and its "
                f"{len(g1)} gradients bitwise loss_fn's (tied table "
                f"within {table:.3g}), segments {model.segment_names()}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.use_deterministic_algorithms(was)
    return out


# ---------------------------------------------------------------------------
# slice 15: main path 14 (the last four families served) and main path 15
# (the last four families trained), and their kernels at their shapes
# ---------------------------------------------------------------------------

# main path 14: (arch, naive check) served whole at full width with
# main path 4's prompts (8 x 1,024 tokens, 31 decode steps): phi-3-vision
# with its 576 patches ahead of each prompt, whisper-tiny with its 1,500
# frames; xLSTM has no attention, so no naive check
FAMILY_SERVE = (("phi-3-vision-4.2b", True), ("zamba2-7b", True),
                ("xlstm-350m", False), ("whisper-tiny", True))
# main path 15: (arch, layers kept: None for the full depth) trained at
# full width, main path 10's batch and recipe, 3 steps + 1 eval batch:
# phi-3-vision at 4 of its 32 layers, zamba2-7b at 12 of its 81 (two
# groups of 6 mamba layers, so both shared blocks run: ~1.6 G parameters,
# ~20 bytes each on the DP step beside ~1.5 GB of chunked-GLA
# activations a mamba layer), xlstm-350m at 8 of its 24 (one segment: 7
# mLSTM layers and an sLSTM one; whole, its host-bound sLSTM loops took
# 7.2 s a step, 53 s of script for the path), whisper-tiny whole
FAMILY_TRAIN = (("phi-3-vision-4.2b", 4), ("zamba2-7b", 12),
                ("xlstm-350m", 8), ("whisper-tiny", None))
FAMILY_TRAIN_STEPS = 3
VLM_PATCHES, WHISPER_FRAMES = 576, 1500
# phase 3g: flash_attention at main path 14's prefill shapes (bf16 and
# f32): phi-3-vision's 576 + 1,024 rows at Dh 96, zamba2-7b's shared
# attention at Dh 112 under its 4,096-token serving window, whisper-tiny's
# non-causal encoder (1,500 keys: no whole 64-row tile at the end), its
# causal decoder and its non-causal cross attention (1,024 x 1,500)
SLICE15_FLASH = {
    "phi-3-vision-4.2b prefill": (SERVE_BATCH, VLM_PATCHES + SERVE_PROMPT,
                                  VLM_PATCHES + SERVE_PROMPT, 32, 32, 96,
                                  True, None),
    "zamba2-7b prefill": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 32,
                          112, True, 4096),
    "whisper-tiny encoder": (SERVE_BATCH, WHISPER_FRAMES, WHISPER_FRAMES, 6,
                             6, 64, False, None),
    "whisper-tiny decoder": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 6, 6,
                             64, True, None),
    "whisper-tiny cross": (SERVE_BATCH, SERVE_PROMPT, WHISPER_FRAMES, 6, 6,
                           64, False, None),
}
# ... and (bf16) at main path 15's training shapes (batch 4)
SLICE15_PATH_FLASH = {
    "phi-3-vision-4.2b training": (LM_TRAIN_BATCH,
                                   VLM_PATCHES + LM_TRAIN_SEQ,
                                   VLM_PATCHES + LM_TRAIN_SEQ, 32, 32, 96,
                                   True, None),
    "zamba2-7b training": (LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_SEQ, 32,
                           32, 112, True, None),
    "whisper-tiny encoder training": (LM_TRAIN_BATCH, WHISPER_FRAMES,
                                      WHISPER_FRAMES, 6, 6, 64, False, None),
    "whisper-tiny cross training": (LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                    WHISPER_FRAMES, 6, 6, 64, False, None),
}
# rmsnorm (bf16) at main path 14's norm sites: prefill and decode rows at
# phi-3-vision's d 3,072, zamba2-7b's d 3,584 (the mamba input norm, the
# shared blocks, the final norm) and 7,168 (the mamba output norm), and
# xLSTM's mLSTM output norm at d 2,048
SLICE15_RMSNORM = {
    "phi-3-vision-4.2b prefill": (SERVE_BATCH * (VLM_PATCHES + SERVE_PROMPT),
                                  3072),
    "phi-3-vision-4.2b decode": (SERVE_BATCH, 3072),
    "zamba2-7b prefill": (SERVE_BATCH * SERVE_PROMPT, 3584),
    "zamba2-7b prefill d_in": (SERVE_BATCH * SERVE_PROMPT, 7168),
    "zamba2-7b decode": (SERVE_BATCH, 3584),
    "zamba2-7b decode d_in": (SERVE_BATCH, 7168),
    "xlstm-350m prefill": (SERVE_BATCH * SERVE_PROMPT, 2048),
    "xlstm-350m decode": (SERVE_BATCH, 2048),
}


def slice15_kernel_phase(torch):
    """Phase 3g: ``flash_attention`` (bf16 and f32) at main path 14's
    prefill shapes and (bf16) at main path 15's training shapes, and
    ``rmsnorm`` (bf16, the model's rounding order) at main path 14's norm
    sites, each against its plain version (the tolerances of phase 3d)
    and timed with its library call (SDPA, with a boolean mask for the
    window; ``F.rms_norm``) and its bound."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    flash = flash_shape_cases(torch, gen, SLICE15_FLASH,
                              ("bfloat16", "float32"))
    flash.update(flash_shape_cases(torch, gen, SLICE15_PATH_FLASH))
    return {"flash_attention": flash,
            "rmsnorm": rmsnorm_shape_cases(torch, gen, SLICE15_RMSNORM)}


def kept_state_entries(torch, state, peak_gib: float):
    """``state_entries`` of a finished run, kept for the next run's
    bitwise comparison: on the card, no copy, when their bytes and the
    run's peak fit in 85% of the card's memory (the next run peaks about
    as high), else copied to the host (zamba2-7b's 12-layer state, ~18
    GiB beside a ~52 GiB peak; a host round trip of ~20 GB costs ~15 s).
    Returns (entries, "card" or "host")."""
    entries = state_entries(state)
    held = sum(v.numel() * v.element_size() for k, v in entries.items()
               if k != "opt/step")
    total = torch.cuda.get_device_properties(0).total_memory
    if held + peak_gib * 2 ** 30 < 0.85 * total:
        return entries, "card"
    return {k: v if k == "opt/step" else v.to("cpu")
            for k, v in entries.items()}, "host"


def family_train_path(torch, libs, arch: str, layers):
    """Main path 15 (and 13), one config: ``arch`` trained at full width
    (``layers`` None: full depth too), main path 10's batch (4 x 1,024
    tokens, with phi-3-vision's 576 patches or whisper-tiny's 1,500
    frames a row), bf16 and recipe, 3 steps and one eval batch through
    the ``Trainer`` on one device, then through the DP step at world
    size 1 over NCCL, bitwise the one-device run (losses, parameters,
    ``delta``, ``m``, ``opt.step``; deterministic algorithms on; the
    one-device state waits where ``kept_state_entries`` puts it).
    phi-3-vision, which has a staged
    loss, also runs the DP step with ``overlap_comm=True`` (embed with
    ``vision_proj``, 4 layer segments, head; 16 MiB buckets), bitwise
    the bucketed DP step. Returns ({run: launches}, {run: stats})."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed import shutdown

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    runs = [("one_device", False, None), ("dp", True, None)]
    if cfg.family == "vlm":
        runs.append(("dp_overlap", True, {
            "overlap_comm": True, "bucket_bytes": OVERLAP_BUCKET_MIB << 20}))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    launches, stats, prev = {}, {}, None
    try:
        for i, (name, dp, build) in enumerate(runs):
            r, launches[name], stats[name], _ = lm_train_run(
                torch, libs, cfg, dp, FAMILY_TRAIN_STEPS, build)
            losses = [h["loss"] for h in r.history]
            if prev is not None:
                ref_name, ref_losses, ref_entries = prev
                differ = bits_differ(torch, ref_entries,
                                     state_entries(r.state))
                log(f"  {name} vs {ref_name}: losses {losses} equal "
                    f"{losses == ref_losses}, {len(differ)} of "
                    f"{len(ref_entries)} state entries differ {differ[:6]}")
                assert losses == ref_losses and not differ, (name, differ)
            if i + 1 < len(runs):  # the next run's yardstick
                kept, stats[name]["state_kept_on"] = kept_state_entries(
                    torch, r.state, stats[name]["peak_mem_gib"])
                prev = (name, losses, kept)
            del r
            torch.cuda.empty_cache()
    finally:
        shutdown()
        torch.use_deterministic_algorithms(was)
    stats["n_layers"], stats["full_depth"] = cfg.n_layers, layers is None
    return launches, stats


# ---------------------------------------------------------------------------
# slice 17: the GSPMD mode (main paths 16 and 17), per-layer remat
# ---------------------------------------------------------------------------

GSPMD_WORKERS = 2  # main paths 16 and 17: two processes share the card
GSPMD_STEPS = 3
GSPMD_RESNET_MESH = (2, 1)  # main path 16: --mesh 2x1, pure DP
GSPMD_LM_MESH = (1, 2)  # main path 17: --mesh 1x2, tensor parallel
REMAT_STEPS = 2  # phase 16c: main path 10 with remat against without
# main path 16's first update in f32 against one process on the 64-image
# batch: the first loss and the parameters by relative norm (the sync-BN
# tolerances of tests/test_torch_sync_bn.py: measured 3.2e-7 and
# 1.2e-4), the first step's BN statistics relative to each site's
# largest magnitude (measured 9.7e-6), and, measured, the worst leaf
# (2.4e-2) and the second loss (2.5e-3):
# ResNet-50's gradient at full depth is ill-conditioned in f32 (the 16
# blocks' BN backwards cancel), so that a batch permuted within one
# process moves it 1.3e-2 (on the CPU at 64 px), two half batches against
# one whole 1.9e-2
GSPMD_LOSS_RTOL, GSPMD_STATS_RTOL, GSPMD_PARAM_TOL = 2e-5, 2e-5, 2e-4
GSPMD_LEAF_TOL, GSPMD_SECOND_LOSS_RTOL = 5e-2, 5e-3
# main path 17's first loss against main path 10's (same seed, batch and
# weights): TP's row-parallel partial sums round differently in bf16
# (measured 4.2e-5)
GSPMD_TP_LOSS_RTOL = 2e-4
# phase 3h: the LM kernels at main path 17's worker-local shapes
SLICE17_FLASH = {
    "llama3.2-1b TP 2 training": (LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                  LM_TRAIN_SEQ, 16, 4, 64, True, None),
}
SLICE17_RMSNORM = {
    "llama3.2-1b TP 2 training": (LM_TRAIN_BATCH * LM_TRAIN_SEQ, 2048),
}


def tp_local_shapes(cfg, mesh_sizes, device: str = "cuda", parallel=None):
    """Each parameter's shape on one worker of a GSPMD mesh
    (``{axis: size}``) by the launcher's rules, or by ``parallel``'s
    (where the update runs: ZeRO-1's specs over the parameters' own
    when it says ``zero_1``); the whole tree is drawn on ``device`` for
    its shapes, then freed."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.distributed.sharding import make_rules, spec_for
    from repro_torch.models import build_model
    from repro_torch.optim.zero import zero_spec_for
    parallel = parallel or ParallelConfig(dp_axes=("data",),
                                          tp_axis="model", zero_1=False)
    rules = make_rules(cfg, mesh_sizes, parallel)
    params, axes = build_model(cfg, device=device).init_params(
        0, draw_device=device)
    shapes = {}
    for name, a in axes.items():
        shape = list(params.pop(name).shape)
        spec = spec_for(a, rules)
        if parallel.zero_1:
            spec = zero_spec_for(tuple(shape), spec, mesh_sizes,
                                 parallel.dp_axes)
        for d, e in enumerate(spec):
            for ax in ((e,) if isinstance(e, str) else (e or ())):
                shape[d] //= mesh_sizes[ax]
        shapes[name] = tuple(shape)
    return shapes


def tp_update_case(torch, gen, cfg, mesh_sizes, what: str, parallel=None):
    """``hybrid_update`` over one worker's shards of every leaf of
    ``cfg`` on a GSPMD mesh (``tp_local_shapes``) in one launch, bitwise
    per leaf against its plain version (weight decay 0, as the LM paths
    train), timed against the per-leaf plain version and its bound."""
    from repro_torch.core.optimizer import HybridHyper
    from repro_torch.kernels import fused_update as fu
    shapes = tp_local_shapes(cfg, mesh_sizes, parallel=parallel)
    dev = torch.device("cuda")
    names = sorted(shapes)
    gs, ps, ds, ms = ([torch.randn(shapes[k], generator=gen, device=dev)
                       * sc for k in names]
                      for sc in (1e-3, 1e-2, 1e-3, 1e-6))
    ms = [m.abs() for m in ms]
    h = HybridHyper(eta=0.1, alpha_sgd=0.0)
    kern = [[t.clone() for t in ts] for ts in (ps, ds, ms)]
    fu.fused_hybrid_update_leaves(gs, *kern, h, [0.0] * len(names))
    for i, g in enumerate(gs):
        plain = [t[i].clone() for t in (ps, ds, ms)]
        fu.PLAIN["hybrid_update"](g, *plain, h, 0.0)
        for field, a, b in zip(("theta", "delta", "m"),
                               (kern[0][i], kern[1][i], kern[2][i]), plain):
            _bitwise(f"hybrid_update {what} {cfg.name} {names[i]} {field}",
                     a, b)
        del plain
    del kern
    total = sum(g.numel() for g in gs)

    def plain_all():
        for i, g in enumerate(gs):
            fu.PLAIN["hybrid_update"](g, ps[i], ds[i], ms[i], h, 0.0)

    upd = {"arch": cfg.name, "n_layers": cfg.n_layers, "leaves": len(names),
           "elements": total, "max_abs_err": 0.0,
           "ms": time_ms(torch, lambda: fu.fused_hybrid_update_leaves(
               gs, ps, ds, ms, h, [0.0] * len(names)), iters=3, trials=3),
           "plain_ms": time_ms(torch, plain_all, iters=2, trials=3),
           "library_ms": None}
    upd["bound_ms"], upd["bound_by"] = bound(28 * total,
                                             UPDATE_FLOPS * total)
    log(f"  hybrid_update over one {what} worker's shards of {cfg.name} "
        f"({cfg.n_layers} layers, {len(names)} leaves, {total} elements) in "
        f"one launch, bitwise: {upd['ms']:.3f} ms (plain "
        f"{upd['plain_ms']:.3f}, bound {upd['bound_ms']:.3f})")
    del gs, ps, ds, ms
    torch.cuda.empty_cache()
    return upd


def slice17_kernel_phase(torch):
    """Phase 3h: ``flash_attention`` (bf16) at main path 17's
    worker-local heads (16 of llama3.2-1b's 32 query heads, 4 of its 8
    kv heads, Dh 64), ``rmsnorm`` at its rows (the rows stay whole under
    TP), and ``hybrid_update`` over one worker's shards of every leaf
    in one launch, each against its plain version (bitwise for the
    update) and timed with its library call and bound."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device="cuda").manual_seed(17)
    out = {"flash_attention": flash_shape_cases(torch, gen, SLICE17_FLASH),
           "rmsnorm": rmsnorm_shape_cases(torch, gen, SLICE17_RMSNORM)}
    out["hybrid_update"] = tp_update_case(
        torch, gen, get_config(LM_TRAIN_ARCH),
        dict(zip(("data", "model"), GSPMD_LM_MESH)), "TP")
    return out


def remat_phase(torch, libs):
    """Phase 16c: main path 10 on one device, ``REMAT_STEPS`` steps and
    one eval batch, with remat (each layer group checkpointed: the JAX
    launcher's ``n_layers > 8``) and without: the same losses and state,
    bitwise; each run's step times, launches and peak memory."""
    from repro_torch.configs import get_config
    cfg = get_config(LM_TRAIN_ARCH)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs, entries, differ = {}, None, []
    try:
        for remat in (True, False):
            r, launches, stats, _ = lm_train_run(
                torch, libs, cfg, False, REMAT_STEPS, {"remat": remat})
            runs["remat" if remat else "no_remat"] = stats
            if entries is None:
                entries = train_state_bits(r.state)
            else:
                differ = bits_differ(torch, entries, state_entries(r.state))
            del r
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(was)
    same = runs["remat"]["losses"] == runs["no_remat"]["losses"]
    log(f"  remat vs not: losses equal {same}, {len(differ)} of "
        f"{len(entries)} state entries differ {differ[:6]}; median step "
        f"{runs['remat']['median_step_ms']:.2f} ms vs "
        f"{runs['no_remat']['median_step_ms']:.2f} ms, peak "
        f"{runs['remat']['peak_mem_gib']:.2f} GiB vs "
        f"{runs['no_remat']['peak_mem_gib']:.2f} GiB")
    assert same and not differ, differ
    runs["bitwise"] = True
    return runs


def kernel_libs():
    """The six kernel modules, in ``main``'s order (their launch
    counters)."""
    from repro_torch.kernels import bucket_ops as bo
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_bn as fb
    from repro_torch.kernels import fused_input as fi
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import rmsnorm as rn
    return (fb, fu, bo, fi, fa, rn)


def _leaf_rel(a, b):
    """Each leaf's relative norm |a - b| / |b| in float64."""
    return {k: float((a[k].double() - b[k].double()).norm()
                     / max(float(b[k].double().norm()), 1e-30)) for k in b}


def _host(tree):
    return {k: v.detach().float().cpu() for k, v in tree.items()}


def _bn_host(mstate):
    return {f"{site}/{k}": t.detach().float().cpu()
            for site, rec in mstate.items() for k, t in rec.items()
            if k in ("mean", "var")}


def _gspmd_run(torch, libs, cfg, build, steps: int):
    """``steps`` steps of a ``build_train_setup`` run on host batches,
    the kernel counts set to 0 just before them: (record, state, step,
    data)."""
    from repro_torch.launch.train import build_train_setup
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, state, step, data, _, _ = build_train_setup(cfg, **build)
    rec = {"setup_s": time.perf_counter() - t0}
    torch.cuda.synchronize()
    reset_counts(libs)
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, met = step(state, data.batch_at(i))
        losses.append(float(met["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    rec.update(losses=losses, step_ms=times, launches=read_counts(libs),
               median_step_ms=statistics.median(times[1:] or times),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return rec, state, step, data


def _first_update(torch, cfg, build):
    """Two steps of a run: the losses, the first step's BN statistics and
    the parameters after the first update (on the host, f32)."""
    from repro_torch.launch.train import build_train_setup
    from repro_torch.training.gspmd import gather_tree
    _, state, step, data, _, _ = build_train_setup(cfg, **build)
    state, met = step(state, data.batch_at(0))
    losses = [float(met["loss"])]
    stats = _bn_host(state["model_state"])
    params = _host(gather_tree(state["params"]))
    state, met = step(state, data.batch_at(1))
    losses.append(float(met["loss"]))
    return losses, stats, params


def gspmd_resnet_worker(rank: int, out_dir: str) -> None:
    """One of main path 16's two processes, both on the one card, joined
    over gloo: ResNet-50 at full width, ``--dp-mode gspmd --mesh 2x1
    --fused-bn --use-fused-kernel``, 32 images a worker, bf16,
    ``GSPMD_STEPS`` steps (then 2 more under torch.profiler); then main
    path 5's step (shardmap, sync-BN, bf16+bucketed) on the same rows and
    weights, whose state and losses must be bitwise the GSPMD step's;
    then the first update in f32 (TF32 off, an f32 wire, momentum SGD):
    the GSPMD step's, and, rank 0 alone, the one-device step's on the
    64-image batch. Rank 0 writes ``rank0.json``; cuDNN is held to
    deterministic algorithms."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.distributed import shutdown

    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark = True, False
    libs = kernel_libs()
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=GSPMD_WORKERS)
    cfg = get_config("resnet50")
    common = dict(global_batch=GSPMD_WORKERS * BATCH, seq_len=0,
                  opt_cfg=OptimizerConfig(), steps_per_epoch=4,
                  use_fused_kernel=True, fused_bn=True, seed=0,
                  device="cuda")
    bf16 = dict(common, compute_dtype=torch.bfloat16)
    # the f32 check: an f32 wire and a first update linear in the
    # gradient (the warm-up's first RMSprop update is ~lr x sign(g), so a
    # near-zero gradient element that rounds the other way moves the
    # other way)
    f32 = dict(common, compute_dtype=torch.float32,
               opt_cfg=OptimizerConfig(kind="momentum_sgd",
                                       schedule="constant"))
    out = {}
    try:
        rec, state, step, data = _gspmd_run(
            torch, libs, cfg, dict(dp_mode="gspmd",
                                   mesh_shape=GSPMD_RESNET_MESH,
                                   compression="bf16", **bf16), GSPMD_STEPS)
        # each worker's whole copy of the replicated state
        kept = {k: v if k == "opt/step" else
                (v.to_local() if hasattr(v, "to_local") else v).clone()
                for k, v in state_entries(state).items()}
        rec["profile"] = profile_phase(torch, step, state, data, steps=2)
        out["gspmd"] = rec
        del state, step, data
        rec, state, _, _ = _gspmd_run(
            torch, libs, cfg, dict(dp_mode="shardmap", sync_bn=True,
                                   compression="bf16+bucketed", **bf16),
            GSPMD_STEPS)
        differ = bits_differ(torch, kept, state_entries(state))
        rec["entries"], rec["differ"] = len(kept), differ[:8]
        rec["n_differ"] = len(differ)
        out["shardmap_sync_bn"] = rec
        del state, kept
        torch.backends.cuda.matmul.allow_tf32 = False
        cudnn.allow_tf32 = False
        out["f32_gspmd"] = _first_update(torch, cfg, dict(
            dp_mode="gspmd", mesh_shape=GSPMD_RESNET_MESH,
            compression="none", **f32))
        shutdown()
        if rank == 0:
            losses, stats, params = out.pop("f32_gspmd")
            one_losses, one_stats, one = _first_update(
                torch, cfg, dict(dp_mode="none", compression="none", **f32))
            rel = _leaf_rel(params, one)
            out["f32"] = {
                "losses": losses, "one_device_losses": one_losses,
                "loss_rel": [abs(a - b) / abs(b)
                             for a, b in zip(losses, one_losses)],
                "stats_rel_worst": max(
                    float((stats[k] - v).abs().max()
                          / v.abs().max().clamp_min(1e-30))
                    for k, v in one_stats.items()),
                "param_rel_norm": param_rel_norm(params, one),
                "param_rel_worst": max(rel.values()),
                "param_rel_worst_leaf": max(rel, key=rel.get)}
            with open(os.path.join(out_dir, "rank0.json"), "w") as f:
                json.dump(out, f)
    finally:
        shutdown()


def gspmd_resnet_path(torch):
    """Main path 16 (``gspmd_resnet_worker``): the GSPMD step's
    launches of the BN and update kernels (each worker's: path 2's a
    step), its state and losses after ``GSPMD_STEPS`` steps bitwise main
    path 5's step at the same two workers (the gradients are bf16 values
    in bf16 compute: the f32 sum of two, rounded once, is gloo's bf16
    sum of two), and its first update in f32 against one process on the
    64-image batch, f32 wire and momentum SGD (``GSPMD_LOSS_RTOL`` for
    the first loss, ``GSPMD_SECOND_LOSS_RTOL`` for the second,
    ``GSPMD_STATS_RTOL`` for the first step's BN statistics,
    ``GSPMD_PARAM_TOL`` and ``GSPMD_LEAF_TOL`` for the parameters); its
    step time and the device's idle share under the profiler."""
    import shutil
    import tempfile


    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_gspmd_")
    t0 = time.perf_counter()
    try:
        spawn(gspmd_resnet_worker, args=(root,), nprocs=GSPMD_WORKERS)
        with open(os.path.join(root, "rank0.json")) as f:
            out = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    g, sm, f32 = out["gspmd"], out["shardmap_sync_bn"], out["f32"]
    log(f"  GSPMD 2x1 (bf16) losses {g['losses']} vs main path 5's step at "
        f"2 workers {sm['losses']}: {sm['n_differ']} of {sm['entries']} "
        f"state entries differ {sm['differ']}")
    log(f"  f32 first update vs one process on the 64-image batch: losses "
        f"{f32['losses']} vs {f32['one_device_losses']} (rel diff "
        f"{f32['loss_rel']}); the first step's BN statistics worst rel "
        f"{f32['stats_rel_worst']:.3g}; params rel norm "
        f"{f32['param_rel_norm']:.3g}, worst leaf "
        f"{f32['param_rel_worst']:.3g} ({f32['param_rel_worst_leaf']})")
    log(f"  GSPMD step ms {[round(t, 2) for t in g['step_ms']]} (median "
        f"{g['median_step_ms']:.2f}), main path 5's step at 2 workers "
        f"{sm['median_step_ms']:.2f}; peak {g['peak_gib']:.2f} GiB a "
        f"worker; worker 0 idle share {g['profile']['device_idle_share']:.3f}"
        f"; launches {g['launches']} (path 5's step: {sm['launches']})")
    assert all(math.isfinite(v) for v in g["losses"]), g["losses"]
    kernels = ("bn_stats", "bn_apply", "bn_bwd_sums", "bn_bwd_dx",
               "hybrid_update")
    assert all(g["launches"][k] > 0 for k in kernels), g["launches"]
    assert g["launches"]["bn_stats"] == 53 * GSPMD_STEPS, g["launches"]
    assert g["losses"] == sm["losses"] and not sm["n_differ"], sm
    assert f32["loss_rel"][0] <= GSPMD_LOSS_RTOL, f32
    assert f32["loss_rel"][1] <= GSPMD_SECOND_LOSS_RTOL, f32
    assert f32["stats_rel_worst"] <= GSPMD_STATS_RTOL, f32
    assert f32["param_rel_norm"] <= GSPMD_PARAM_TOL, f32
    assert f32["param_rel_worst"] <= GSPMD_LEAF_TOL, f32
    out["spawn_s"] = time.perf_counter() - t0
    return g["launches"], out


def gspmd_lm_worker(rank: int, out_dir: str) -> None:
    """One of main path 17's two processes, both on the one card, joined
    over gloo: llama3.2-1b at full size, ``--dp-mode gspmd --mesh 1x2``
    (Megatron TP 2), remat on, bf16, flash attention on each worker's
    heads, the fused update on its shards, main path 10's batch, seed
    and recipe, ``GSPMD_STEPS`` steps; deterministic algorithms on.
    Writes ``rank{rank}.json``."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.distributed import shutdown

    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=GSPMD_WORKERS)
    try:
        rec, state, _, _ = _gspmd_run(
            torch, kernel_libs(), get_config(LM_TRAIN_ARCH), dict(
                global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                opt_cfg=OptimizerConfig(**LM_TRAIN_OPT),
                steps_per_epoch=LM_TRAIN_STEPS, dp_mode="gspmd",
                mesh_shape=GSPMD_LM_MESH, compute_dtype=torch.bfloat16,
                attention_impl="chunked", use_fused_kernel=True,
                compression="bf16", draw_device="cuda", device="cuda"),
            GSPMD_STEPS)
        rec["local_parameters"] = sum(p.to_local().numel()
                                      for p in state["params"].values())
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        shutdown()


def gspmd_lm_path(torch, ref_first_loss: float):
    """Main path 17 (``gspmd_lm_worker``): both workers' losses finite
    and equal, the first within ``GSPMD_TP_LOSS_RTOL`` of main path 10's
    one-device first loss, and each worker's launches: flash at every
    layer twice a step (the forward and its recompute), rmsnorm at
    every norm site and again at the recomputed ones, one fused update a
    step."""
    import shutil
    import tempfile


    from repro_torch.configs import get_config

    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    t0 = time.perf_counter()
    try:
        spawn(gspmd_lm_worker, args=(root,), nprocs=GSPMD_WORKERS)
        ranks = []
        for r in range(GSPMD_WORKERS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = get_config(LM_TRAIN_ARCH)
    want = {k: 0 for k in ranks[0]["launches"]}
    want.update(lm_launches(cfg, GSPMD_STEPS, GSPMD_STEPS, GSPMD_STEPS))
    want["hybrid_update"] = GSPMD_STEPS
    first_rel = abs(ranks[0]["losses"][0] - ref_first_loss) / abs(
        ref_first_loss)
    for r, rec in enumerate(ranks):
        log(f"  worker {r}: losses {rec['losses']}, step ms "
            f"{[round(t, 1) for t in rec['step_ms']]} (median "
            f"{rec['median_step_ms']:.1f}), set-up {rec['setup_s']:.1f}s, "
            f"peak {rec['peak_gib']:.2f} GiB, {rec['local_parameters']} "
            f"local parameters, launches {rec['launches']}")
    log(f"  first loss {ranks[0]['losses'][0]} vs main path 10's "
        f"{ref_first_loss}: rel diff {first_rel:.3g}")
    assert all(math.isfinite(v) for v in ranks[0]["losses"]), ranks
    assert ranks[0]["losses"] == ranks[1]["losses"], ranks
    assert all(rec["launches"] == want for rec in ranks), (ranks, want)
    assert first_rel <= GSPMD_TP_LOSS_RTOL, first_rel
    return ranks[0]["launches"], {"workers": ranks,
                                  "first_loss_rel_vs_path10": first_rel,
                                  "spawn_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# slice 18: every family under a model axis (main paths 18 and 19)
# ---------------------------------------------------------------------------

# main path 18: MoE under EP (--dp-mode gspmd --mesh 1x2): mixtral
# trained at main path 13's cut (1 of 32 layers; 4 of its 8 experts and
# half the vocabulary a worker), then the GSPMD prefill and decode steps
# of mixtral at 4 of 32 layers (8 until PR 29, which cut it to make room
# for paths 20 and 21: its one-device reference runs at the same cut)
# and maverick at one group (64 of its 128 experts a worker)
GSPMD_MOE_TRAIN = ((MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS),)
GSPMD_MOE_SERVE = (("mixtral-8x7b", 4), ("llama4-maverick-400b-a17b", 2))
# main path 19: the other four families under TP, trained at main path
# 15's cuts (zamba2 needs its 12 layers there: two groups, so both
# shared blocks take a gradient), served at them but zamba2's, cut to 6
# (one group, one shared block) for paths 20 and 21's room
GSPMD_FAMILY_TRAIN = FAMILY_TRAIN
GSPMD_FAMILY_SERVE = tuple((arch, 6 if arch == "zamba2-7b" else layers)
                           for arch, layers in FAMILY_TRAIN)
GSPMD_TRAIN_STEPS, GSPMD_DECODE_STEPS = 2, 4
# the first loss of each path-18 / 19 run against its one-device step
GSPMD_FAMILY_LOSS_RTOL = 2e-4
# path 18's logits (the prefill's and each teacher-forced decode step's)
# against the one-device run's, the routing replayed: the bound of the
# flash vs naive prefill (phase 18)
GSPMD_MOE_SERVE_TOL = NAIVE_REL_TOL
# path 19's logits (prefill and each teacher-forced decode step) against
# the one-device run's in bf16, by family, about twice the largest
# measured: TP rounds each row-parallel product's halves before their
# sum. Measured 1.47e-2 phi-3-vision, 2.59e-2 zamba2, 4.57e-2 xLSTM,
# 8.06e-3 whisper; each below its one-device bf16 prefill's distance
# from the f32 one (2.25e-2, 3.10e-2, 7.78e-2, 8.26e-3): the scale of
# bf16's own rounding, which xLSTM's exponential input gates amplify;
# xLSTM's bound is that own distance, rounded up
GSPMD_FAMILY_SERVE_TOL = {"phi-3-vision-4.2b": 3e-2, "zamba2-7b": 5e-2,
                          "xlstm-350m": 8e-2, "whisper-tiny": 2e-2}
# the witness that path 19's bf16 distance is rounding: the same GSPMD
# prefill in f32 against one device's in f32 (measured 8.5e-7 whisper to
# 7.7e-6 xLSTM)
GSPMD_F32_WITNESS = {18: (), 19: GSPMD_FAMILY_SERVE}
GSPMD_F32_SERVE_TOL = 1e-4
# a greedy choice of a GSPMD serve step may differ from one device's only
# where one device's two candidates lie within this many logits of each
# other: two bf16 ulps at logits in [4, 8) (measured: the choices that
# differed had gaps of 0 to 0.046875, xLSTM's widest)
GSPMD_TIE_GAP = 0.0625
# phase 3i: flash_attention (bf16) at paths 18 and 19's worker-local
# heads, (B, Sq, Sk, Hq, Hkv, Dh, causal, window) ...
SLICE18_FLASH = {
    "mixtral-8x7b EP 2 training": (LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                   LM_TRAIN_SEQ, 16, 4, 128, True, 4096),
    "mixtral-8x7b EP 2 prefill": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT,
                                  16, 4, 128, True, 4096),
    "llama4-maverick EP 2 prefill": (SERVE_BATCH, SERVE_PROMPT,
                                     SERVE_PROMPT, 20, 4, 128, True, None),
    "phi-3-vision-4.2b TP 2 training": (LM_TRAIN_BATCH,
                                        VLM_PATCHES + LM_TRAIN_SEQ,
                                        VLM_PATCHES + LM_TRAIN_SEQ, 16, 16,
                                        96, True, None),
    "phi-3-vision-4.2b TP 2 prefill": (SERVE_BATCH,
                                       VLM_PATCHES + SERVE_PROMPT,
                                       VLM_PATCHES + SERVE_PROMPT, 16, 16,
                                       96, True, None),
    "zamba2-7b TP 2 training": (LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_SEQ,
                                16, 16, 112, True, None),
    "zamba2-7b TP 2 prefill": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16,
                               16, 112, True, 4096),
    "whisper-tiny TP 2 encoder training": (LM_TRAIN_BATCH, WHISPER_FRAMES,
                                           WHISPER_FRAMES, 3, 3, 64, False,
                                           None),
    "whisper-tiny TP 2 cross training": (LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                         WHISPER_FRAMES, 3, 3, 64, False,
                                         None),
    "whisper-tiny TP 2 decoder training": (LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                           LM_TRAIN_SEQ, 3, 3, 64, True,
                                           None),
    "whisper-tiny TP 2 encoder prefill": (SERVE_BATCH, WHISPER_FRAMES,
                                          WHISPER_FRAMES, 3, 3, 64, False,
                                          None),
    "whisper-tiny TP 2 cross prefill": (SERVE_BATCH, SERVE_PROMPT,
                                        WHISPER_FRAMES, 3, 3, 64, False,
                                        None),
}
# ... and rmsnorm (bf16) at their rows, whole under TP: the training
# rows of each width, and the out_norm sites made whole (zamba2's d_in
# 7,168 and xLSTM's 2,048) at a prefill's and a decode step's rows
SLICE18_RMSNORM = {
    "mixtral-8x7b training": (LM_TRAIN_BATCH * LM_TRAIN_SEQ, 4096),
    "phi-3-vision-4.2b training": (
        LM_TRAIN_BATCH * (VLM_PATCHES + LM_TRAIN_SEQ), 3072),
    "zamba2-7b training": (LM_TRAIN_BATCH * LM_TRAIN_SEQ, 3584),
    "zamba2-7b training out_norm": (LM_TRAIN_BATCH * LM_TRAIN_SEQ, 7168),
    "zamba2-7b prefill out_norm": (SERVE_BATCH * SERVE_PROMPT, 7168),
    "zamba2-7b decode out_norm": (SERVE_BATCH, 7168),
    "xlstm-350m training out_norm": (LM_TRAIN_BATCH * LM_TRAIN_SEQ, 2048),
    "xlstm-350m prefill out_norm": (SERVE_BATCH * SERVE_PROMPT, 2048),
    "xlstm-350m decode out_norm": (SERVE_BATCH, 2048),
}


def slice18_kernel_phase(torch):
    """Phase 3i: ``flash_attention`` (bf16) at main paths 18 and 19's
    worker-local heads and ``rmsnorm`` at their rows (whole under TP,
    ``out_norm``'s too), each against its plain version (the tolerances
    of phase 3d) and timed with its library call and bound; and
    ``hybrid_update`` over one worker's shards of each config the two
    paths train (mixtral's experts under EP, the others' TP shards),
    bitwise per leaf against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    out = {"flash_attention": flash_shape_cases(torch, gen, SLICE18_FLASH),
           "rmsnorm": rmsnorm_shape_cases(torch, gen, SLICE18_RMSNORM)}
    mesh = dict(zip(("data", "model"), GSPMD_LM_MESH))
    out["hybrid_update"] = {
        arch: tp_update_case(torch, gen, _cut_config(arch, layers), mesh,
                             "EP" if arch == MOE_TRAIN_ARCH else "TP")
        for arch, layers in GSPMD_MOE_TRAIN + GSPMD_FAMILY_TRAIN}
    return out


def _cut_config(arch: str, layers):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _family_train_build(torch, **kw):
    """``build_train_setup``'s options of main paths 13 and 15 (one
    device) and 18 and 19 (``kw``: the GSPMD mode)."""
    from repro_torch.configs import OptimizerConfig
    return dict(global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                opt_cfg=OptimizerConfig(**LM_TRAIN_OPT),
                steps_per_epoch=FAMILY_TRAIN_STEPS,
                compute_dtype=torch.bfloat16, attention_impl="chunked",
                use_fused_kernel=True, compression="bf16",
                draw_device="cuda", device="cuda", **kw)


def _serve_inputs(torch, cfg, dtype=None):
    """Main path 12 / 14's requests (8 prompts of 1,024 tokens, a VLM's
    patches, an audio model's frames) on the card, the patches and
    frames in ``dtype`` (bf16)."""
    from repro_torch.launch.serve import make_requests
    req = make_requests(cfg, SERVE_BATCH, SERVE_PROMPT)
    batch = {"tokens": torch.from_numpy(req.pop("tokens")).to("cuda")}
    batch.update({k: torch.from_numpy(v).to("cuda", dtype or torch.bfloat16)
                  for k, v in req.items()})
    return batch


def _last_logits(torch, prefill, params, cache, batch):
    """The prefill's last-position logits, on the host in f32."""
    logits, _ = prefill(params, cache, batch)
    return logits[:, -1].float().cpu()


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _greedy(torch, prefill, decode, params, cache, batch, steps: int,
            libs=None, forced=None):
    """A prefill and ``steps`` decode steps, each fed the last call's
    argmax token or (``forced``, teacher forcing) ``forced[:, i]``:
    (each call's last logits on the host in f32, the argmax tokens (B,
    steps + 1), per-call ms, the launches of the prefill and of the
    first decode step when ``libs`` is given)."""
    counts, ms, out = {}, [], []
    if libs is not None:
        reset_counts(libs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, batch)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
    if libs is not None:
        counts["prefill"] = read_counts(libs)
    toks = []
    for i in range(steps + 1):
        out.append(logits[:, -1].float().cpu())
        toks.append(torch.argmax(logits[:, -1], -1))
        if i == steps:
            break
        if libs is not None and i == 0:
            reset_counts(libs)
        feed = toks[-1] if forced is None else forced[:, i]
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, {
            "tokens": feed[:, None],
            "cache_index": batch["tokens"].shape[1] + i})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if libs is not None and i == 0:
            counts["decode"] = read_counts(libs)
    return out, torch.stack(toks, 1), ms, counts


def gspmd_family_refs(torch, out_dir: str, train, serve, witness=()):
    """The one-device references of main paths 18 and 19, in the main
    process before the spawn: for each ``train`` (arch, layers) the
    first step of main path 13 / 15's run (its loss; its MoE routing
    recorded, ``RouteTape``), for each ``serve`` (arch, layers) a
    prefill of main path 12 / 14's requests and ``GSPMD_DECODE_STEPS``
    greedy decode steps, bf16, flash (the logits, the tokens, the
    routing of every MoE call), and for each ``witness`` (arch, layers)
    the same prefill in f32 (its last logits, and their distance from
    the bf16 prefill's: the scale of bf16's own rounding). Tapes and
    logits go to ``out_dir`` for the workers; returns {key: record}."""
    from repro_torch.launch.serve import build_serve_setup
    from repro_torch.launch.train import build_train_setup
    from repro_torch.models import layers as mlayers
    from repro_torch.training.step import make_decode_step, make_prefill_step

    refs = {}
    for arch, layers in train:
        cfg = _cut_config(arch, layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, state, step, data, _, _ = build_train_setup(
            cfg, dp_mode="none", **_family_train_build(torch))
        tape = RouteTape(mlayers._route)
        mlayers._route = tape
        try:
            state, met = step(state, data.batch_at(0))
        finally:
            mlayers._route = tape.route
        refs[f"train {arch}"] = {
            "loss": float(met["loss"]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        torch.save([c.cpu() for c in tape.calls],
                   os.path.join(out_dir, f"train_tape_{arch}.pt"))
        del state, step, data, tape, met
    for arch, layers in serve:
        cfg = _cut_config(arch, layers)
        torch.cuda.empty_cache()
        model, params = build_serve_setup(
            cfg, compute_dtype=torch.bfloat16, attention_impl="chunked",
            device="cuda", draw_device="cuda")
        cache, _ = model.cache_shape(SERVE_BATCH,
                                     SERVE_PROMPT + GSPMD_DECODE_STEPS + 1,
                                     torch.bfloat16)
        tape = RouteTape(mlayers._route)
        mlayers._route = tape
        try:
            logits, toks, ms, _ = _greedy(
                torch, make_prefill_step(model), make_decode_step(model),
                params, cache, _serve_inputs(torch, cfg), GSPMD_DECODE_STEPS)
        finally:
            mlayers._route = tape.route
        torch.save({"logits": logits, "tokens": toks.cpu(),
                    "tape": [c.cpu() for c in tape.calls]},
                   os.path.join(out_dir, f"serve_{arch}.pt"))
        refs[f"serve {arch}"] = {"tokens": toks.cpu().tolist(), "ms": ms}
        del model, params, cache, logits, tape
    for arch, layers in witness:
        cfg = _cut_config(arch, layers)
        torch.cuda.empty_cache()
        model, params = build_serve_setup(
            cfg, compute_dtype=torch.float32, attention_impl="chunked",
            device="cuda", draw_device="cuda")
        cache, _ = model.cache_shape(SERVE_BATCH,
                                     SERVE_PROMPT + GSPMD_DECODE_STEPS + 1,
                                     torch.float32)
        got = _last_logits(torch, make_prefill_step(model), params, cache,
                           _serve_inputs(torch, cfg, torch.float32))
        torch.save(got, os.path.join(out_dir, f"serve32_{arch}.pt"))
        bf16 = torch.load(os.path.join(out_dir, f"serve_{arch}.pt"))
        refs[f"serve {arch}"]["bf16_vs_f32"] = _rel(bf16["logits"][0], got)
        del model, params, cache, bf16
    torch.cuda.empty_cache()
    return refs


def gspmd_family_worker(rank: int, out_dir: str, path: int) -> None:
    """One of main path 18's (``path`` 18) or 19's two processes, both on
    the one card, joined over gloo, ``--dp-mode gspmd --mesh 1x2``: each
    train config of the path (``GSPMD_TRAIN_STEPS`` steps, the first
    one's routing replayed from the one-device step's tape), then each
    serve config's GSPMD prefill and ``GSPMD_DECODE_STEPS`` decode
    steps fed the one-device run's greedy tokens (the routing replayed,
    ``build_gspmd_serve_setup``'s weights, the cache placed by
    ``place_cache``), the kernel counts set to 0 before each run and
    read after it. Writes ``rank{rank}.json``: each run's record, with
    its logits' errors and the greedy choices that differ from the
    one-device run's."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import shutdown
    from repro_torch.launch.serve import build_gspmd_serve_setup
    from repro_torch.launch.train import build_train_setup
    from repro_torch.models import layers as mlayers
    from repro_torch.training.gspmd import place_cache
    from repro_torch.training.step import make_decode_step, make_prefill_step

    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=GSPMD_WORKERS)
    train, serve = ((GSPMD_MOE_TRAIN, GSPMD_MOE_SERVE) if path == 18 else
                    (GSPMD_FAMILY_TRAIN, GSPMD_FAMILY_SERVE))
    libs = kernel_libs()
    out = {}
    try:
        for arch, layers in train:
            cfg = _cut_config(arch, layers)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, state, step, data, _, _ = build_train_setup(
                cfg, **_family_train_build(torch, dp_mode="gspmd",
                                           mesh_shape=GSPMD_LM_MESH))
            rec = {"setup_s": time.perf_counter() - t0}
            tape = None
            if cfg.n_experts:  # the first step routes as the reference's
                tape = RouteTape(mlayers._route, replay=RouteTape(None))
                tape.replay.calls = torch.load(
                    os.path.join(out_dir, f"train_tape_{arch}.pt"),
                    map_location="cuda")
            torch.cuda.synchronize()
            reset_counts(libs)
            losses, times = [], []
            for i in range(GSPMD_TRAIN_STEPS):
                mlayers._route = tape if tape and i == 0 else mlayers._route
                t0 = time.perf_counter()
                try:
                    state, met = step(state, data.batch_at(i))
                finally:
                    mlayers._route = getattr(tape, "route", mlayers._route)
                losses.append(float(met["loss"]))
                times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            rec.update(losses=losses, step_ms=times,
                       launches=read_counts(libs),
                       median_step_ms=statistics.median(times[1:] or times),
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       local_parameters=sum(p.to_local().numel() for p in
                                            state["params"].values()))
            if tape is not None:
                rec["flipped_tokens"] = tape.flipped
                rec["routed_tokens"] = tape.tokens
            out[f"train {arch}"] = rec
            del state, step, data
            torch.cuda.empty_cache()
        for arch, layers in serve:
            cfg = _cut_config(arch, layers)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model, params, mesh, rules = build_gspmd_serve_setup(
                cfg, GSPMD_LM_MESH, compute_dtype=torch.bfloat16,
                attention_impl="chunked", device="cuda", draw_device="cuda")
            setup_s = time.perf_counter() - t0
            ref = torch.load(os.path.join(out_dir, f"serve_{arch}.pt"))
            cache, axes = model.cache_shape(
                SERVE_BATCH, SERVE_PROMPT + GSPMD_DECODE_STEPS + 1,
                torch.bfloat16)
            cache = place_cache(cache, axes, mesh, rules)
            tape = None
            if cfg.n_experts:
                tape = RouteTape(mlayers._route, replay=RouteTape(None))
                tape.replay.calls = [c.to("cuda") for c in ref["tape"]]
                mlayers._route = tape
            try:
                logits, toks, ms, counts = _greedy(
                    torch, make_prefill_step(model, mesh, rules),
                    make_decode_step(model, mesh, rules), params, cache,
                    _serve_inputs(torch, cfg), GSPMD_DECODE_STEPS, libs,
                    forced=ref["tokens"].to("cuda"))
            finally:
                mlayers._route = getattr(tape, "route", mlayers._route)
            want, ref_toks = ref["logits"], ref["tokens"].cpu()
            toks = toks.cpu()
            # each greedy choice that differs: (step, row, the one-device
            # logit gap between its own choice and this run's)
            flips = [[t, r, float(want[t][r, ref_toks[r, t]]
                                  - want[t][r, toks[r, t]])]
                     for t in range(len(want)) for r in range(toks.shape[0])
                     if toks[r, t] != ref_toks[r, t]]
            rec = {"setup_s": setup_s, "prefill_ms": ms[0],
                   "decode_ms": ms[1:], "launches": counts,
                   "tokens": toks.tolist(), "flips": flips,
                   "choices": toks.numel(),
                   "max_abs_err": [float((a - b).abs().max())
                                   for a, b in zip(logits, want)],
                   "rel_norm": [_rel(a, b) for a, b in zip(logits, want)],
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "local_parameters": sum(p.to_local().numel()
                                           for p in params.values())}
            if tape is not None:
                rec["flipped_tokens"] = tape.flipped
                rec["routed_tokens"] = tape.tokens
            out[f"serve {arch}"] = rec
            del model, params, cache, ref, logits
            torch.cuda.empty_cache()
            if (arch, layers) in GSPMD_F32_WITNESS[path]:
                # the same prefill in f32 against one device's in f32
                model, params, mesh, rules = build_gspmd_serve_setup(
                    cfg, GSPMD_LM_MESH, compute_dtype=torch.float32,
                    attention_impl="chunked", device="cuda",
                    draw_device="cuda")
                cache, axes = model.cache_shape(
                    SERVE_BATCH, SERVE_PROMPT + GSPMD_DECODE_STEPS + 1,
                    torch.float32)
                got = _last_logits(
                    torch, make_prefill_step(model, mesh, rules), params,
                    place_cache(cache, axes, mesh, rules),
                    _serve_inputs(torch, cfg, torch.float32))
                rec["f32_rel_norm"] = _rel(got, torch.load(os.path.join(
                    out_dir, f"serve32_{arch}.pt")))
                del model, params, cache
                torch.cuda.empty_cache()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown()


def gspmd_family_path(torch, path: int, ref_losses=None):
    """Main path 18 (``path`` 18: MoE under EP) or 19 (the VLM, zamba2,
    xLSTM and whisper under TP): the one-device references
    (``gspmd_family_refs``), then one spawn of ``gspmd_family_worker``.
    Holds both workers' losses finite and equal, each config's first
    loss within ``GSPMD_FAMILY_LOSS_RTOL`` of its one-device step
    (``ref_losses``: main path 13 / 15's first losses by arch; a MoE
    config's step runs again for its routing, logged beside them),
    the logits of each prefill and teacher-forced decode step to the
    one-device run's (``GSPMD_MOE_SERVE_TOL`` with the routing replayed,
    the family's ``GSPMD_FAMILY_SERVE_TOL``), path 19's f32 prefill to
    one device's f32 prefill (``GSPMD_F32_SERVE_TOL``), each greedy
    choice the one-device run's but at a tie (``GSPMD_TIE_GAP``), and
    each worker's launches: flash and
    rmsnorm as ``lm_launches`` counts them on one device (the heads are
    a worker's, the rows whole), one fused update a step. Returns
    (launches of worker 0 summed over the runs, stats)."""
    import shutil
    import tempfile


    train, serve = ((GSPMD_MOE_TRAIN, GSPMD_MOE_SERVE) if path == 18 else
                    (GSPMD_FAMILY_TRAIN, GSPMD_FAMILY_SERVE))
    root = tempfile.mkdtemp(prefix=f"chip_smoke_gspmd{path}_")
    t0 = time.perf_counter()
    try:
        # a MoE config's reference step is run again for its routing;
        # the others' first losses are main path 15's
        refs = gspmd_family_refs(
            torch, root, [(a, n) for a, n in train
                          if _cut_config(a, n).n_experts or
                          a not in (ref_losses or {})], serve,
            GSPMD_F32_WITNESS[path])
        for arch, _ in train:
            if f"train {arch}" not in refs:
                refs[f"train {arch}"] = {"loss": ref_losses[arch]}
        refs_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"  one-device references in {refs_s:.1f}s; this process "
            f"holds {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB on "
            f"the card before the spawn")
        t1 = time.perf_counter()
        spawn(gspmd_family_worker, args=(root, path),
                 nprocs=GSPMD_WORKERS)
        spawn_s = time.perf_counter() - t1
        ranks = []
        for r in range(GSPMD_WORKERS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = None
    for arch, layers in train:
        cfg = _cut_config(arch, layers)
        key = f"train {arch}"
        recs = [rk[key] for rk in ranks]
        want = {k: 0 for k in recs[0]["launches"]}
        remat = cfg.n_layers > 8
        want.update(lm_launches(cfg, GSPMD_TRAIN_STEPS, GSPMD_TRAIN_STEPS,
                                GSPMD_TRAIN_STEPS if remat else 0))
        want["hybrid_update"] = GSPMD_TRAIN_STEPS
        ref = refs[key]["loss"]
        rel = abs(recs[0]["losses"][0] - ref) / abs(ref)
        recs[0]["first_loss_rel"] = rel
        recs[0]["one_device_first_loss"] = ref
        logged = (ref_losses or {}).get(arch)
        log(f"  {key} ({cfg.n_layers} layers): losses {recs[0]['losses']}, "
            f"step ms {[round(t, 1) for t in recs[0]['step_ms']]}, peak "
            f"{recs[0]['peak_gib']:.2f} GiB, {recs[0]['local_parameters']} "
            f"local parameters, launches {recs[0]['launches']} (want "
            f"{want}); first loss {recs[0]['losses'][0]} vs one device "
            f"{ref} (the earlier path's {logged}): rel {rel:.3g}"
            + (f"; {recs[0]['flipped_tokens']} of {recs[0]['routed_tokens']}"
               " token routings differ (replayed)"
               if "flipped_tokens" in recs[0] else ""))
        assert all(math.isfinite(v) for v in recs[0]["losses"]), recs
        assert recs[0]["losses"] == recs[1]["losses"], recs
        assert all(r["launches"] == want for r in recs), (recs, want)
        assert rel <= GSPMD_FAMILY_LOSS_RTOL, (key, rel)
        total = dict(recs[0]["launches"]) if total is None else {
            k: total[k] + v for k, v in recs[0]["launches"].items()}
    for arch, layers in serve:
        cfg = _cut_config(arch, layers)
        key = f"serve {arch}"
        recs = [rk[key] for rk in ranks]
        for phase, (fw, pre) in (("prefill", (1, 1)), ("decode", (1, 0))):
            want = {k: 0 for k in recs[0]["launches"][phase]}
            want.update(lm_launches(cfg, fw, pre))
            assert all(r["launches"][phase] == want for r in recs), (
                key, phase, [r["launches"] for r in recs], want)
            total = {k: total[k] + v
                     for k, v in recs[0]["launches"][phase].items()}
        flips = recs[0]["flips"]
        tol = (GSPMD_MOE_SERVE_TOL if path == 18 else
               GSPMD_FAMILY_SERVE_TOL[arch])
        witness = ("" if "f32_rel_norm" not in recs[0] else
                   f"; in f32, prefill logits vs one device's in f32: rel "
                   f"norm {recs[0]['f32_rel_norm']:.3g} (bound "
                   f"{GSPMD_F32_SERVE_TOL}), one device's bf16 prefill vs "
                   f"its f32 one {refs[key]['bf16_vs_f32']:.3g}")
        log(f"  {key} ({cfg.n_layers} layers): prefill "
            f"{recs[0]['prefill_ms']:.1f} ms, decode ms "
            f"{[round(t, 1) for t in recs[0]['decode_ms']]}, set-up "
            f"{recs[0]['setup_s']:.1f}s, peak {recs[0]['peak_gib']:.2f} GiB, "
            f"{recs[0]['local_parameters']} local parameters, launches "
            f"{recs[0]['launches']}; logits vs one device, the prefill's "
            f"and each teacher-forced decode step's: rel norm "
            f"{[float(f'{e:.3g}') for e in recs[0]['rel_norm']]} (bound "
            f"{tol}), max abs error "
            f"{[round(e, 4) for e in recs[0]['max_abs_err']]}{witness}; "
            f"greedy "
            f"choices (teacher-forced by one device's) differing: "
            f"{len(flips)} of {recs[0]['choices']} {flips}"
            + (f"; {recs[0]['flipped_tokens']} of {recs[0]['routed_tokens']}"
               " token routings differ (replayed)"
               if "flipped_tokens" in recs[0] else ""))
        assert recs[0]["tokens"] == recs[1]["tokens"], key
        assert all(gap <= GSPMD_TIE_GAP for _, _, gap in flips), (key,
                                                                 flips)
        assert max(recs[0]["rel_norm"]) <= tol, (key, recs[0]["rel_norm"])
        if "f32_rel_norm" in recs[0]:
            assert recs[0]["f32_rel_norm"] <= GSPMD_F32_SERVE_TOL, (
                key, recs[0]["f32_rel_norm"])
    for k in ("flash_attention", "rmsnorm", "hybrid_update"):
        assert total[k] > 0, (path, k, total)
    return total, {"workers": ranks, "one_device": refs,
                   "refs_s": refs_s, "spawn_s": spawn_s,
                   "path_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# slice 19: every placement of the GSPMD policy (main paths 20 and 21)
# ---------------------------------------------------------------------------

# main path 20: yi-9b at full width, 1 of its 48 layers (cut from 2),
# trained under its own policy, cell_parallel(yi-9b, ShapeConfig("train",
# 1024, 4)):
# FSDP ("embed" over "data"), Megatron TP over "model", ZeRO-1, the bf16
# wire, each layer checkpointed; --mesh 2x2, four processes on the card
FSDP_ARCH, FSDP_LAYERS = "yi-9b", 1
FSDP_MESH, FSDP_WORKERS, FSDP_STEPS = (2, 2), 4, 2
# the first loss against one device's on the same weights and batch
# (path 17's TP measured 4.24e-5)
FSDP_LOSS_RTOL = 2e-4
# in f32 (compute and wire), one step of path 10's recipe on this layout
# against one device's f32 step from the same weights: each leaf's
# relative norm within the CPU tests' 2e-4 (the shards' update and its
# write-back under FSDP x TP x ZeRO-1, measured 4.69e-5; and so without
# fsdp_params, where ZeRO-1's shards move: with FSDP they match the
# parameters' own and nothing is written back). Every leaf's
# own step (one device's, from the initial weights: what an update
# never applied reads; measured 2.8e-3 at least) must lie above the
# bound
HYBRID_F32_TOL = 2e-4
# microbatches=2 against microbatches=1 in the same processes, in f32
# (compute and wire): the logged loss (the mean of the microbatches'),
# and the parameters after one step: each leaf within 2e-4 relative norm
# (the CPU tests' bound), and at most ACCUM_RARE of its elements outside
# the JAX package's own f32 accumulation bound (ACCUM_PARAM_TOL,
# tests/test_grad_accumulation.py, "~1% relative on rare elements": the
# RMSprop warm-up's rsqrt of near-zero second moments amplifies the sum
# order's noise). One device's microbatches=2 against its own 1 at the
# same width is the control, logged beside: on an H100 80GB HBM3 at
# 700 W it put 12 elements of 6 leaves outside that bound (worst leaf
# 4.89e-5, max abs 8.57e-4) where the mesh put 5 of 3 (2.88e-5,
# 5.36e-4). The bf16 run's accumulation is held by its loss alone, not
# by its parameters (in bf16 8 of 12 leaves held elements outside that
# bound, max abs 5.6e-3: a tiny gradient's bf16 rounding flips an
# RMSprop step of +-lr)
ACCUM_LOSS_RTOL, ACCUM_LEAF_TOL = 1e-5, 2e-4
ACCUM_PARAM_TOL, ACCUM_RARE = dict(rtol=2e-2, atol=2e-4), 1e-5
# LARS on the same layout, one step, against one device's LARS, in f32
# (compute and wire: in bf16 the sharded gradient's roundings moved the
# trust ratios 7.47e-5): the trust ratios (whole-leaf norms summed over
# the shards) and each leaf's relative norm, measured 5.85e-9 at worst;
# one LARS step moves a leaf by about eta x trust_coef = 1e-4 of its
# norm (measured 1.0e-4 at least), which the run measures (one device's
# step from the initial weights) and which must lie above the bound
FSDP_LARS_OPT = dict(kind="lars", schedule="poly")
LARS_TRUST_RTOL, LARS_PARAM_TOL = 1e-5, 1e-7
# main path 21: granite-34b at full width, main path 9's cut of 8 of 88
# layers, served under cell_parallel(granite-34b, ShapeConfig("prefill",
# 4096, 1)): TP over "model", sequence parallelism (batch 1) and the
# cache's positions on "model" (its one kv head cannot split);
# --mesh 1x2, two processes on the card, one 4,096-token prompt, a
# prefill and 4 decode steps teacher-forced by one device's tokens
SP_ARCH, SP_LAYERS, SP_MESH, SP_WORKERS = "granite-34b", 8, (1, 2), 2
SP_PROMPT, SP_DECODE = 4096, 4
# the logits (the prefill's and each decode step's) against one device's
# in bf16 (rel norm): one device's own bf16-vs-f32 distance rounded up
# (measured: 8.55e-3 to 9.06e-3 against its 9.36e-3, on an H100 80GB
# HBM3 at 700 W). The two bf16 runs round apart (TP's partial sums are
# rounded to bf16 before their all-reduce, and summed in another order),
# so they lie as far from each other as each lies from f32, and no bf16
# bound below that distance separates the precisions: the gates are the
# f32 GSPMD prefill against one device's f32 prefill (measured 3.6e-6),
# and the bf16 GSPMD prefill's own distance from one device's f32
# prefill, within SP_F32_RATIO of one device's bf16 distance from it
SP_SERVE_TOL, SP_F32_TOL, SP_F32_RATIO = 1e-2, 1e-4, 1.5
# phase 3j: the kernels at paths 20 and 21's worker-local shapes
SLICE19_FLASH = {
    "granite-34b SP prefill, the gathered sequence, all heads":
        (1, SP_PROMPT, SP_PROMPT, 48, 1, 128, True, None),
    "granite-34b SP prefill, a worker's heads":
        (1, SP_PROMPT, SP_PROMPT, 24, 1, 128, True, None),
    "yi-9b FSDP x TP training, a worker's heads":
        (LM_TRAIN_BATCH // FSDP_MESH[0], LM_TRAIN_SEQ, LM_TRAIN_SEQ,
         32 // FSDP_MESH[1], 4 // FSDP_MESH[1], 128, True, None),
}
SLICE19_RMSNORM = {
    "yi-9b FSDP x TP training, a worker's rows":
        (LM_TRAIN_BATCH // FSDP_MESH[0] * LM_TRAIN_SEQ, 4096),
}


def fsdp_parallel():
    """Main path 20's ``ParallelConfig``: the JAX package's policy for
    the whole yi-9b (its cut has fewer than 3e9 parameters, which the
    policy would train pure DP)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import cell_parallel
    return cell_parallel(get_config(FSDP_ARCH), ShapeConfig(
        "train", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train"))


def sp_parallel():
    """Main path 21's ``ParallelConfig``: the policy of granite-34b's
    batch-1 prefill."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import cell_parallel
    return cell_parallel(get_config(SP_ARCH), ShapeConfig(
        "prefill", SP_PROMPT, 1, "prefill"))


def slice19_kernel_phase(torch):
    """Phase 3j: ``flash_attention`` (bf16) at main path 21's prefill
    (granite-34b's 4,096 tokens whole under sequence parallelism, its
    48 heads and a worker's 24, on one kv head) and main path 20's
    worker-local heads, ``rmsnorm`` at main path 20's rows (a worker's
    2,048 of yi-9b's width), each against its plain version and timed
    with its library call and bound; ``hybrid_update`` over one worker's
    FSDP x TP x ZeRO-1 shards of main path 20's leaves, bitwise."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    out = {"flash_attention": flash_shape_cases(torch, gen, SLICE19_FLASH),
           "rmsnorm": rmsnorm_shape_cases(torch, gen, SLICE19_RMSNORM)}
    out["hybrid_update"] = tp_update_case(
        torch, gen, _cut_config(FSDP_ARCH, FSDP_LAYERS),
        dict(zip(("data", "model"), FSDP_MESH)), "FSDP x TP x ZeRO-1",
        parallel=fsdp_parallel())
    return out


def leaf_gaps(torch, a, b, p=None):
    """``a``'s distance from ``b``, a leaf's (or, with ``p`` its DTensor,
    a worker's shards of it: summed over the workers, each copy counted
    once): the largest absolute difference, the relative norm and the
    elements outside ``ACCUM_PARAM_TOL``."""
    a, b = a.double(), b.to(a.device).double()
    sq = torch.stack([(a - b).square().sum(), b.square().sum(),
                      (~torch.isclose(a, b, **ACCUM_PARAM_TOL)).sum()
                      .double()])
    big = (a - b).abs().max().reshape(1)
    if p is not None:
        import torch.distributed as dist
        dist.all_reduce(sq)
        dist.all_reduce(big, op=dist.ReduceOp.MAX)
        sq /= math.prod(p.device_mesh.size(i)
                        for i, q in enumerate(p.placements) if q.is_replicate())
    return {"max_abs": float(big),
            "rel": float(sq[0].sqrt() / sq[1].sqrt().clamp_min(1e-30)),
            "outside": int(sq[2]), "elements": (a if p is None else p).numel()}


def _fsdp_build(torch, opt, f32=False, **kw):
    """``build_train_setup``'s options of main path 20 (one device, or
    with ``kw`` the GSPMD mode): path 10's batch and recipe (``opt``),
    bf16 and the bf16 wire (``f32``: f32 both), flash, the fused update,
    weights drawn on the card; the wire goes into ``kw["parallel"]``
    where there is one."""
    import dataclasses

    from repro_torch.configs import OptimizerConfig
    wire = "none" if f32 else "bf16"
    if "parallel" in kw:
        kw["parallel"] = dataclasses.replace(kw["parallel"], compression=wire)
    else:
        kw["compression"] = wire
    return dict(global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                opt_cfg=OptimizerConfig(**opt),
                steps_per_epoch=LM_TRAIN_STEPS,
                compute_dtype=torch.float32 if f32 else torch.bfloat16,
                attention_impl="chunked", use_fused_kernel=True,
                draw_device="cuda", device="cuda", **kw)


def fsdp_refs(torch, out_dir: str):
    """Main path 20's one-device references, in the main process before
    the spawn: the first step's loss of path 10's recipe (bf16); in f32,
    one step of that recipe and one LARS step (their parameters to
    ``out_dir``, and each leaf's step from the initial weights), and
    the recipe's step with ``microbatches=2`` against its step with 1
    (the accumulation's control)."""
    from repro_torch.launch.train import build_train_setup
    from repro_torch.optim.lars import tape_trust_ratios
    cfg = _cut_config(FSDP_ARCH, FSDP_LAYERS)
    refs = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, state, step, data, _, _ = build_train_setup(
        cfg, dp_mode="none", **_fsdp_build(torch, LM_TRAIN_OPT))
    t0 = time.perf_counter()
    state, met = step(state, data.batch_at(0))
    torch.cuda.synchronize()
    refs.update(loss=float(met["loss"]),
                step_ms=(time.perf_counter() - t0) * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del state, step, data, met
    for key, opt, mb in (("hybrid", LM_TRAIN_OPT, 1),
                         ("accum", LM_TRAIN_OPT, 2),
                         ("lars", FSDP_LARS_OPT, 1)):
        torch.cuda.empty_cache()
        _, state, step, data, _, _ = build_train_setup(
            cfg, dp_mode="none", microbatches=mb,
            **_fsdp_build(torch, opt, f32=True))
        start = {k: v.detach().clone() for k, v in state["params"].items()}
        with tape_trust_ratios() as trust:
            state, met = step(state, data.batch_at(0))
        params = {k: v.detach() for k, v in state["params"].items()}
        refs[key] = {"loss": float(met["loss"]), "trust": list(trust),
                     "step": {k: leaf_gaps(torch, v, start[k])["rel"]
                               for k, v in params.items()}}
        del start
        if key == "accum":  # against the step with one microbatch
            one = torch.load(os.path.join(out_dir, "hybrid_params.pt"),
                             mmap=True)
            refs[key]["vs_one_microbatch"] = {
                k: leaf_gaps(torch, v, one[k]) for k, v in params.items()}
            del one
        else:
            torch.save({k: v.cpu() for k, v in params.items()},
                       os.path.join(out_dir, f"{key}_params.pt"))
        del state, step, data, met, params
    torch.cuda.empty_cache()
    return refs


def gspmd_fsdp_worker(rank: int, out_dir: str) -> None:
    """One of main path 20's four processes, all on the one card, joined
    over gloo as ``--mesh 2x2``: yi-9b at 2 layers under its own policy
    (``fsdp_parallel``), ``FSDP_STEPS`` steps of path 10's batch and
    recipe; the same run without ``fsdp_params`` (TP x ZeRO-1; its peak
    memory beside); in f32, one step of the recipe with and without
    ``fsdp_params`` (against one device's, ``fsdp_refs``), one with
    ``microbatches=2`` (against the one with 1), and one LARS step
    (against one device's). The kernel
    counts are set to 0 before each run's steps, DTensor's own
    collectives counted; each worker's parameter elements by leaf.
    Writes ``rank{rank}.json``."""
    sys.path.insert(0, SRC)
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.distributed import shutdown
    from repro_torch.distributed.sharding import (count_dtensor_collectives,
                                                  local_slice)
    from repro_torch.launch.train import build_train_setup
    from repro_torch.optim.lars import tape_trust_ratios

    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=FSDP_WORKERS)
    calls = count_dtensor_collectives()
    libs = kernel_libs()
    cfg = _cut_config(FSDP_ARCH, FSDP_LAYERS)
    par = fsdp_parallel()
    out = {}

    def run(key, parallel, steps, opt=LM_TRAIN_OPT, mb=1, f32=False):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, state, step, data, _, _ = build_train_setup(cfg, **_fsdp_build(
            torch, opt, f32, dp_mode="gspmd", mesh_shape=FSDP_MESH,
            parallel=parallel, microbatches=mb))
        torch.cuda.synchronize()
        rec = {"setup_s": time.perf_counter() - t0,
               "setup_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(libs)
        calls.update(n=0, on=True)
        losses, times = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            state, met = step(state, data.batch_at(i))
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        calls["on"] = False
        field = next(v for v in state["opt"].values() if isinstance(v, dict))
        rec.update(losses=losses, step_ms=times, launches=read_counts(libs),
                   moved=sorted(k for k, p in state["params"].items()
                                if tuple(field[k].placements)
                                != tuple(p.placements)),
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   dtensor_collectives=calls["n"],
                   local={k: p.to_local().numel()
                          for k, p in state["params"].items()},
                   whole={k: p.numel() for k, p in state["params"].items()},
                   placements={k: [str(q) for q in p.placements]
                               for k, p in state["params"].items()},
                   local_param_bytes=sum(p.to_local().numel() *
                                         p.to_local().element_size()
                                         for p in state["params"].values()))
        out[key] = rec
        return state["params"]

    def vs_one_device(params, name):  # each worker's shards, no gather
        ref = torch.load(os.path.join(out_dir, f"{name}_params.pt"),
                         mmap=True)
        return {k: leaf_gaps(torch, p.to_local(), local_slice(
            ref[k], p.device_mesh, p.placements), p)
            for k, p in params.items()}

    try:
        run("fsdp", par, FSDP_STEPS)
        run("no_fsdp", dataclasses.replace(par, fsdp_params=False), 1)
        params = run("accum1", par, 1, f32=True)
        out["accum1"]["vs_one_device"] = vs_one_device(params, "hybrid")
        tp_zero = run("tp_zero", dataclasses.replace(par, fsdp_params=False),
                      1, f32=True)  # ZeRO-1's shards written back
        out["tp_zero"]["vs_one_device"] = vs_one_device(tp_zero, "hybrid")
        del tp_zero
        kept = {k: p.to_local().detach().clone() for k, p in params.items()}
        del params
        params = run("accum", par, 1, mb=2, f32=True)  # kept's layout
        out["accum"]["vs_one_microbatch"] = {
            k: leaf_gaps(torch, p.to_local(), kept[k], p)
            for k, p in params.items()}
        del params, kept
        with tape_trust_ratios() as trust:
            params = run("lars", par, 1, opt=FSDP_LARS_OPT, f32=True)
        out["lars"]["trust"] = list(trust)
        out["lars"]["vs_one_device"] = vs_one_device(params, "lars")
        del params
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown()


def _worst(gaps):
    """(leaf, relative norm) of the leaf furthest from its reference."""
    return max(((k, v["rel"]) for k, v in gaps.items()), key=lambda kv: kv[1])


def gspmd_fsdp_path(torch):
    """Main path 20 (``gspmd_fsdp_worker``, four processes on the card):
    every worker's losses finite and equal; the first within
    ``FSDP_LOSS_RTOL`` of one device's (``fsdp_refs``); each worker's
    parameter elements exactly a quarter of every leaf split over both
    axes (the leaves split over "data" alone, a half, listed); its peak
    memory in the steps below the same run's without ``fsdp_params``;
    in f32, the recipe's step within ``HYBRID_F32_TOL`` of one device's
    (and so without ``fsdp_params``, where ZeRO-1's shards move and are
    written back),
    ``microbatches=2``'s loss within ``ACCUM_LOSS_RTOL`` of the whole
    batch's and its parameters within ``ACCUM_LEAF_TOL`` (at most
    ``ACCUM_RARE`` of a leaf outside ``ACCUM_PARAM_TOL``; one device's
    own count beside), LARS's trust ratios within ``LARS_TRUST_RTOL`` of
    one device's and its parameters within ``LARS_PARAM_TOL``, each
    parameter bound below every leaf's own step; no DTensor all-gather,
    reduce-scatter or all-to-all; the launches: flash at every layer
    twice a step (the forward and its recompute), rmsnorm at every norm
    site and at the recomputed ones, one fused update a step (none for
    LARS). Returns (worker 0's launches of the first run, stats)."""
    import shutil
    import tempfile


    cfg = _cut_config(FSDP_ARCH, FSDP_LAYERS)
    root = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
    t0 = time.perf_counter()
    try:
        refs = fsdp_refs(torch, root)
        refs_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        spawn(gspmd_fsdp_worker, args=(root,), nprocs=FSDP_WORKERS)
        spawn_s = time.perf_counter() - t1
        ranks = []
        for r in range(FSDP_WORKERS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec = ranks[0]
    fsdp = rec["fsdp"]
    for key in ("fsdp", "no_fsdp", "accum1", "tp_zero", "accum", "lars"):
        r = rec[key]
        log(f"  {key}: losses {r['losses']}, step ms "
            f"{[round(t, 1) for t in r['step_ms']]}, set-up "
            f"{r['setup_s']:.1f}s (peak {r['setup_peak_gib']:.2f} GiB), "
            f"peak in the steps {r['peak_gib']:.2f} GiB, "
            f"{r['local_param_bytes'] / 2 ** 30:.3f} GiB of parameters a "
            f"worker, launches {r['launches']}, DTensor collectives "
            f"{r['dtensor_collectives']}, leaves updated on ZeRO-1's "
            f"moved shards {len(r['moved'])}")
    first_rel = abs(fsdp["losses"][0] - refs["loss"]) / abs(refs["loss"])
    quarter = sorted(k for k in fsdp["whole"]
                     if 4 * fsdp["local"][k] == fsdp["whole"][k])
    other = {k: fsdp["local"][k] / fsdp["whole"][k] for k in fsdp["whole"]
             if k not in quarter}
    smallest = {k: min(refs[k]["step"].items(), key=lambda kv: kv[1])
             for k in ("hybrid", "lars")}
    hybrid_worst = _worst(rec["accum1"]["vs_one_device"])
    zero_worst = _worst(rec["tp_zero"]["vs_one_device"])
    one_mb = rec["accum1"]["losses"][0]
    accum_rel = abs(rec["accum"]["losses"][0] - one_mb) / abs(one_mb)
    vs_one = rec["accum"]["vs_one_microbatch"]
    accum_bad = {k: v for k, v in vs_one.items()
                 if v["rel"] > ACCUM_LEAF_TOL
                 or v["outside"] > ACCUM_RARE * v["elements"]}
    accum_err = max(v["max_abs"] for v in vs_one.values())
    accum_worst = _worst(vs_one)
    accum_outside = {k: v["outside"] for k, v in vs_one.items()
                     if v["outside"]}
    control = refs["accum"]["vs_one_microbatch"]
    trust, trust_ref = rec["lars"]["trust"], refs["lars"]["trust"]
    trust_rel = (max(abs(a - b) / abs(b) for a, b in zip(trust, trust_ref))
                 if len(trust) == len(trust_ref) else float("inf"))
    lars_worst = _worst(rec["lars"]["vs_one_device"])
    log(f"  first loss {fsdp['losses'][0]} vs one device {refs['loss']}: "
        f"rel {first_rel:.3g} (bound {FSDP_LOSS_RTOL}); one device's step "
        f"{refs['step_ms']:.1f} ms, peak {refs['peak_gib']:.2f} GiB")
    log(f"  a worker's parameters: a quarter of {len(quarter)} of "
        f"{len(fsdp['whole'])} leaves; the others (split over 'data' "
        f"alone) {other}; peak in the steps {fsdp['peak_gib']:.2f} GiB "
        f"with FSDP vs {rec['no_fsdp']['peak_gib']:.2f} GiB without")
    log(f"  one step (f32) vs one device's: loss {one_mb} vs "
        f"{refs['hybrid']['loss']}, worst leaf {hybrid_worst[0]} rel "
        f"{hybrid_worst[1]:.3g} (bound {HYBRID_F32_TOL}); the smallest "
        f"leaf step (an update not applied) {smallest['hybrid'][1]:.3g} "
        f"({smallest['hybrid'][0]}); without fsdp_params (TP x ZeRO-1, "
        f"{len(rec['tp_zero']['moved'])} leaves updated on moved shards and "
        f"written back) worst leaf {zero_worst[0]} rel {zero_worst[1]:.3g}")
    log(f"  microbatches=2 (f32): loss {rec['accum']['losses'][0]} vs "
        f"{one_mb} (rel {accum_rel:.3g}, bound "
        f"{ACCUM_LOSS_RTOL}); parameters after one step: worst leaf "
        f"{accum_worst[0]} rel {accum_worst[1]:.3g} (bound "
        f"{ACCUM_LEAF_TOL}), max abs diff {accum_err:.3g}, elements outside "
        f"{ACCUM_PARAM_TOL} by leaf {accum_outside} (at most {ACCUM_RARE} "
        f"of a leaf); failing: {accum_bad}; one device's control: loss "
        f"{refs['accum']['loss']} vs {refs['hybrid']['loss']}, worst leaf "
        f"rel {_worst(control)[1]:.3g}, max abs diff "
        f"{max(v['max_abs'] for v in control.values()):.3g}, elements "
        f"outside by leaf "
        f"{ {k: v['outside'] for k, v in control.items() if v['outside']} }")
    log(f"  LARS (f32): {len(trust)} trust ratios, max rel diff vs one "
        f"device {trust_rel:.3g} (bound {LARS_TRUST_RTOL}); worst leaf "
        f"{lars_worst[0]} rel {lars_worst[1]:.3g} (bound {LARS_PARAM_TOL});"
        f" the smallest leaf step (an update not applied) "
        f"{smallest['lars'][1]:.3g} ({smallest['lars'][0]})")
    want = {k: 0 for k in fsdp["launches"]}
    want.update(lm_launches(cfg, FSDP_STEPS, FSDP_STEPS, FSDP_STEPS))
    want["hybrid_update"] = FSDP_STEPS
    want_accum = dict(want)
    want_accum.update(lm_launches(cfg, 2, 2, 2))
    want_accum["hybrid_update"] = 1
    for r in ranks:
        assert r["fsdp"]["losses"] == fsdp["losses"], ranks
        assert all(r[k]["dtensor_collectives"] == 0 for k in r), r
        assert r["fsdp"]["launches"] == want, (r["fsdp"]["launches"], want)
        assert r["accum"]["launches"] == want_accum, (
            r["accum"]["launches"], want_accum)
        assert r["fsdp"]["peak_gib"] < r["no_fsdp"]["peak_gib"], r
    assert all(math.isfinite(v) for v in fsdp["losses"]), fsdp
    assert first_rel <= FSDP_LOSS_RTOL, first_rel
    assert quarter and all(2 * fsdp["local"][k] == fsdp["whole"][k]
                           for k in other), other
    assert all("norm" in k for k in other), other
    assert HYBRID_F32_TOL < smallest["hybrid"][1], smallest
    assert hybrid_worst[1] <= HYBRID_F32_TOL, hybrid_worst
    assert rec["tp_zero"]["moved"], rec["tp_zero"]["moved"]
    assert zero_worst[1] <= HYBRID_F32_TOL, zero_worst
    assert accum_rel <= ACCUM_LOSS_RTOL, accum_rel
    assert not accum_bad, accum_bad
    assert trust_rel <= LARS_TRUST_RTOL, trust_rel
    assert LARS_PARAM_TOL < smallest["lars"][1], smallest
    assert lars_worst[1] <= LARS_PARAM_TOL, lars_worst
    return fsdp["launches"], {
        "workers": ranks, "one_device": refs,
        "first_loss_rel": first_rel, "quarter_leaves": len(quarter),
        "half_leaves": other, "hybrid_f32_worst": hybrid_worst,
        "tp_zero_f32_worst": zero_worst,
        "accum_loss_rel": accum_rel, "accum_max_abs_diff": accum_err,
        "trust_rel": trust_rel, "lars_worst": lars_worst,
        "smallest_step": smallest, "refs_s": refs_s, "spawn_s": spawn_s,
        "path_s": time.perf_counter() - t0}


def _sp_inputs(torch, cfg):
    """One prompt of ``SP_PROMPT`` tokens (``make_requests``), on the
    card."""
    from repro_torch.launch.serve import make_requests
    tokens = make_requests(cfg, 1, SP_PROMPT)["tokens"]
    return {"tokens": torch.from_numpy(tokens).to("cuda")}


def sp_refs(torch, out_dir: str):
    """Main path 21's one-device references, in the main process before
    the spawn: the bf16 prefill and ``SP_DECODE`` greedy decode steps
    (their logits and tokens, to ``out_dir``), and the f32 prefill (its
    last logits, and the bf16 prefill's distance from them)."""
    from repro_torch.launch.serve import build_serve_setup
    from repro_torch.training.step import make_decode_step, make_prefill_step
    cfg = _cut_config(SP_ARCH, SP_LAYERS)
    refs = {}
    for dt in (torch.bfloat16, torch.float32):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, params = build_serve_setup(
            cfg, compute_dtype=dt, attention_impl="chunked", device="cuda",
            draw_device="cuda")
        cache, _ = model.cache_shape(1, SP_PROMPT + SP_DECODE, dt)
        steps = SP_DECODE if dt == torch.bfloat16 else 0
        logits, toks, ms, _ = _greedy(
            torch, make_prefill_step(model), make_decode_step(model), params,
            cache, _sp_inputs(torch, cfg), steps)
        name = "bf16" if dt == torch.bfloat16 else "f32"
        refs[name] = {"ms": ms, "tokens": toks.cpu().tolist(),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        torch.save({"logits": logits, "tokens": toks.cpu()},
                   os.path.join(out_dir, f"sp_{name}.pt"))
        del model, params, cache
    bf16 = torch.load(os.path.join(out_dir, "sp_bf16.pt"))["logits"][0]
    f32 = torch.load(os.path.join(out_dir, "sp_f32.pt"))["logits"][0]
    refs["bf16_vs_f32"] = _rel(bf16, f32)
    torch.cuda.empty_cache()
    return refs


def gspmd_sp_worker(rank: int, out_dir: str) -> None:
    """One of main path 21's two processes, both on the one card, joined
    over gloo as ``--mesh 1x2``: granite-34b at 8 layers under
    ``sp_parallel`` (``build_gspmd_serve_setup``), the cache placed by
    ``place_cache`` (its positions split over "model"), a bf16 prefill
    of one 4,096-token prompt and ``SP_DECODE`` decode steps fed one
    device's tokens; then the same prefill in f32. The kernel counts are
    set to 0 before the bf16 run, DTensor's own collectives counted.
    Writes ``rank{rank}.json``."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import shutdown
    from repro_torch.distributed.sharding import count_dtensor_collectives
    from repro_torch.launch.serve import build_gspmd_serve_setup
    from repro_torch.training.gspmd import place_cache
    from repro_torch.training.step import make_decode_step, make_prefill_step

    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=SP_WORKERS)
    calls = count_dtensor_collectives()
    libs = kernel_libs()
    cfg = _cut_config(SP_ARCH, SP_LAYERS)
    out = {}
    try:
        for dt in (torch.bfloat16, torch.float32):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model, params, mesh, rules = build_gspmd_serve_setup(
                cfg, SP_MESH, compute_dtype=dt, attention_impl="chunked",
                device="cuda", draw_device="cuda", parallel=sp_parallel())
            setup_s = time.perf_counter() - t0
            name = "bf16" if dt == torch.bfloat16 else "f32"
            ref = torch.load(os.path.join(out_dir, f"sp_{name}.pt"))
            cache, axes = model.cache_shape(1, SP_PROMPT + SP_DECODE, dt)
            cache = place_cache(cache, axes, mesh, rules)
            held = {k: [v.to_local().shape[2], v.shape[2]]
                    for k, v in cache.items()}
            steps = SP_DECODE if dt == torch.bfloat16 else 0
            calls.update(n=0, on=True)
            logits, toks, ms, counts = _greedy(
                torch, make_prefill_step(model, mesh, rules),
                make_decode_step(model, mesh, rules), params, cache,
                _sp_inputs(torch, cfg), steps, libs,
                forced=ref["tokens"].to("cuda") if steps else None)
            calls["on"] = False
            want, ref_toks = ref["logits"], ref["tokens"].cpu()
            toks = toks.cpu()
            flips = [[t, r, float(want[t][r, ref_toks[r, t]]
                                  - want[t][r, toks[r, t]])]
                     for t in range(len(want)) for r in range(toks.shape[0])
                     if toks[r, t] != ref_toks[r, t]]
            out[name] = {
                "setup_s": setup_s, "prefill_ms": ms[0], "decode_ms": ms[1:],
                "launches": counts, "tokens": toks.tolist(), "flips": flips,
                "choices": toks.numel(), "cache_positions": held,
                "rel_norm": [_rel(a, b) for a, b in zip(logits, want)],
                "max_abs_err": [float((a - b).abs().max())
                                for a, b in zip(logits, want)],
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "dtensor_collectives": calls["n"],
                "local_parameters": sum(p.to_local().numel()
                                        for p in params.values())}
            if dt == torch.bfloat16:  # its prefill against one device's f32
                exact = torch.load(os.path.join(out_dir, "sp_f32.pt"))
                out[name]["vs_f32"] = _rel(logits[0], exact["logits"][0])
                del exact
            del model, params, cache, ref, logits
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown()


def gspmd_sp_path(torch):
    """Main path 21 (``gspmd_sp_worker``, two processes on the card):
    each worker's cache leaves hold exactly half of one device's
    positions; the logits of the bf16 prefill and of each teacher-forced
    decode step within ``SP_SERVE_TOL`` of one device's (``sp_refs``;
    one device's own bf16-vs-f32 distance logged beside); the f32 prefill
    within ``SP_F32_TOL`` of one device's f32 prefill, the bf16
    prefill's distance from it within ``SP_F32_RATIO`` of one device's
    bf16 prefill's; a greedy choice
    that differs only at one device's tie (``GSPMD_TIE_GAP``); no
    DTensor all-gather, reduce-scatter or all-to-all; the launches:
    flash at every layer of the prefill (on the whole sequence, a
    worker's heads), none in a decode step. Returns (worker 0's
    launches of the prefill and the first decode step, summed;
    stats)."""
    import shutil
    import tempfile


    cfg = _cut_config(SP_ARCH, SP_LAYERS)
    root = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    t0 = time.perf_counter()
    try:
        refs = sp_refs(torch, root)
        refs_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        spawn(gspmd_sp_worker, args=(root,), nprocs=SP_WORKERS)
        spawn_s = time.perf_counter() - t1
        ranks = []
        for r in range(SP_WORKERS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec, rec32 = ranks[0]["bf16"], ranks[0]["f32"]
    log(f"  one device: bf16 prefill + decode ms "
        f"{[round(t, 1) for t in refs['bf16']['ms']]} (peak "
        f"{refs['bf16']['peak_gib']:.2f} GiB), f32 prefill ms "
        f"{refs['f32']['ms'][0]:.1f}; its bf16 prefill vs its f32 one: rel "
        f"norm {refs['bf16_vs_f32']:.3g}")
    log(f"  SP + kv_seq (bf16): prefill {rec['prefill_ms']:.1f} ms, decode "
        f"ms {[round(t, 1) for t in rec['decode_ms']]}, set-up "
        f"{rec['setup_s']:.1f}s, peak {rec['peak_gib']:.2f} GiB, "
        f"{rec['local_parameters']} local parameters, cache positions held "
        f"{rec['cache_positions']}, launches {rec['launches']}, DTensor "
        f"collectives {rec['dtensor_collectives']}; logits vs one device, "
        f"the prefill's and each teacher-forced decode step's: rel norm "
        f"{[float(f'{e:.3g}') for e in rec['rel_norm']]} (bound "
        f"{SP_SERVE_TOL}), max abs error "
        f"{[round(e, 4) for e in rec['max_abs_err']]}; greedy choices "
        f"differing: {len(rec['flips'])} of {rec['choices']} {rec['flips']}")
    log(f"  f32 witness: prefill {rec32['prefill_ms']:.1f} ms, peak "
        f"{rec32['peak_gib']:.2f} GiB, logits vs one device's f32: rel norm "
        f"{rec32['rel_norm'][0]:.3g} (bound {SP_F32_TOL}); the bf16 "
        f"prefill vs one device's f32: rel norm {rec['vs_f32']:.3g}, "
        f"{rec['vs_f32'] / refs['bf16_vs_f32']:.3g}x one device's bf16 "
        f"(bound {SP_F32_RATIO}x)")
    for r in ranks:
        for name in ("bf16", "f32"):
            x = r[name]
            assert x["dtensor_collectives"] == 0, (name, x)
            assert all(2 * a == b for a, b in x["cache_positions"].values()
                       ), x["cache_positions"]
        for phase, (fw, pre) in (("prefill", (1, 1)), ("decode", (1, 0))):
            want = {k: 0 for k in r["bf16"]["launches"][phase]}
            want.update(lm_launches(cfg, fw, pre))
            assert r["bf16"]["launches"][phase] == want, (
                phase, r["bf16"]["launches"], want)
    assert ranks[0]["bf16"]["tokens"] == ranks[1]["bf16"]["tokens"]
    assert max(rec["rel_norm"]) <= SP_SERVE_TOL, rec["rel_norm"]
    assert rec32["rel_norm"][0] <= SP_F32_TOL, rec32["rel_norm"]
    assert rec["vs_f32"] <= SP_F32_RATIO * refs["bf16_vs_f32"], (
        rec["vs_f32"], refs["bf16_vs_f32"])
    assert all(gap <= GSPMD_TIE_GAP for _, _, gap in rec["flips"]), (
        rec["flips"])
    total = {k: rec["launches"]["prefill"][k] + rec["launches"]["decode"][k]
             for k in rec["launches"]["prefill"]}
    return total, {"workers": ranks, "one_device": refs, "refs_s": refs_s,
                   "spawn_s": spawn_s, "path_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 28: the audit of the recorded step (analysis/audit.py) on the card
# ---------------------------------------------------------------------------

AUDIT_WORKERS = 8  # the JAX audit's layouts: flat 8 x 1, hierarchical 2 x 4
# the JAX package's committed audit record (reduced ResNet-50, 8 devices)
AUDIT_RECORD = os.path.join(ROOT, "AUDIT.json")
# the cells whose qualifying counts the bucket plan fixes; gspmd and
# perleaf differ by design (XLA's combiner merged the JAX package's)
AUDIT_COUNTED = ("bucketed", "overlap", "zero", "zero_overlap", "hier",
                 "hier_overlap", "hier_zero", "hier_zero_overlap")
RESNET50_CONVS = 53
# full ResNet-50's stream-LARS ZeRO cells fail one check of the JAX
# package's contract in both packages (the JAX audit's own --full run of
# zero/lars reads "hierarchical" alike): LARS's trust-ratio sum, (2, 162)
# f32 (1,296 B), moves 2 x 1,296 x 7/8 = 2,268 ring bytes at 8 workers,
# over the contract's 2,048-byte metric floor, which gradient_sync
# compares with ring bytes. The gate holds each to that one violation,
# its largest all-reduce a metric-sized buffer (ROADMAP queue 3). The
# JAX package's record of that cell: tests/data/jax_audit_full_zero_lars.json,
# which tests/test_torch_audit.py holds to the same reading.
AUDIT_FULL_SHARED = {f"{m}/lars": ["collectives.gradient_sync"]
                     for m in ("zero", "zero_overlap", "hier_zero",
                               "hier_zero_overlap")}


def audit_cards_worker(rank: int, out_dir: str) -> None:
    """One of phase 28's eight processes on the card over gloo: the audit
    at full ResNet-50 (the JAX audit's ``--full``), then at the reduced
    config; rank 0 writes both reports."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=AUDIT_WORKERS)
    try:
        from repro_torch.analysis.audit import run_audit
        out = {}
        for name, full in (("full", True), ("reduced", False)):
            t0 = time.perf_counter()
            out[name] = run_audit(full=full, device="cuda", verbose=False)
            out[f"{name}_s"] = time.perf_counter() - t0
        if rank == 0:
            with open(os.path.join(out_dir, "audit.json"), "w") as f:
                json.dump(out, f)
    finally:
        from repro_torch.distributed import shutdown
        shutdown()


def _qualifying(cell):
    return {k: v["execs"] for k, v in
            cell["passes"]["collectives"]["summary"]["per_op"].items()}


def audit_phase(torch):
    """Phase 28: the port's audit on the card, eight processes over gloo.
    (a) all 20 cells (10 sync modes x {sgd, lars}) at full ResNet-50 meet
    the JAX package's contracts unchanged on every worker (but below),
    both ZeRO
    relations hold, and each cell's recorded backward holds one
    ``convolution_backward`` for each of the 53 convolutions; (b) at the
    reduced config the qualifying collective counts and ``gradient_sync``
    of the bucketed, overlapped, ZeRO and hierarchical cells equal
    ``AUDIT.json``'s (gspmd's and perleaf's are printed beside it);
    (c) the ZeRO relations' expected shrink equals ``AUDIT.json``'s.
    Every cell's kernel launches are printed: ``cast_copy`` in every
    bucketed cell, ``seg_sq_partials`` and ``lars_update`` in every
    stream-LARS cell. The four stream-LARS ZeRO cells at full size fail
    the one check the JAX package's own full audit fails
    (``AUDIT_FULL_SHARED``): the gate holds them to exactly that.
    Returns the record and rank 0's full cells."""
    import shutil
    import tempfile


    from repro_torch.analysis.audit import MODES

    root = tempfile.mkdtemp(prefix="chip_smoke_audit_")
    try:
        spawn(audit_cards_worker, args=(root,), nprocs=AUDIT_WORKERS)
        with open(os.path.join(root, "audit.json")) as f:
            rep = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    with open(AUDIT_RECORD) as f:
        jax_rec = json.load(f)
    jax_cells = {(c["mode"], c["optimizer"]): c for c in jax_rec["cells"]}
    out = {"full_s": rep["full_s"], "reduced_s": rep["reduced_s"],
           "cells": {}}
    for name in ("full", "reduced"):
        r = rep[name]
        log(f"  {name}: {len(r['cells'])} cells in {rep[name + '_s']:.1f}s, "
            f"every worker ok {r['ranks_ok']}")
        for c in r["cells"]:
            key = f"{name}/{c['mode']}/{c['optimizer']}"
            if c["violations"]:
                log(f"  {key}: violations {c['violations']}")
            q = _qualifying(c) if c["passes"] else {}
            sync = c["passes"]["collectives"]["summary"]["gradient_sync"] \
                if c["passes"] else None
            secs = c.get("info", {}).get("seconds")
            log(f"  {key}: ok {c['ok']}, qualifying {q}, {sync}, seconds "
                f"(set-up, step, recorded step) {secs}, "
                f"convolution_backward {c.get('convolution_backward')} "
                f"({c.get('convolution_backward_in_backward')} in the "
                f"backward), launches {c.get('kernel_launches')}")
            out["cells"][key] = {"ok": c["ok"], "qualifying": q,
                                 "gradient_sync": sync,
                                 "launches": c.get("kernel_launches")}
        for rel in r["relations"]:
            log(f"  {name} relation {rel['optimizer']}: shrink "
                f"{rel['actual_shrink_bytes']:.0f} B, expected "
                f"{rel['expected_shrink_bytes']:.0f} B, ok {rel['ok']}")
        known = AUDIT_FULL_SHARED if name == "full" else {}
        want = {f"{c['mode']}/{c['optimizer']}": known.get(
            f"{c['mode']}/{c['optimizer']}", []) for c in r["cells"]}
        assert all(v == want for v in r["ranks_verdicts"]), (
            name, r["ranks_verdicts"][0])
        assert all(rel["ok"] for rel in r["relations"]), r["relations"]
        for c in r["cells"]:
            if f"{c['mode']}/{c['optimizer']}" in known:
                summ = c["passes"]["collectives"]["summary"]
                assert summ["gradient_sync"] == "hierarchical"
                assert summ["allreduce_max_bytes"] < \
                    c["expectations"]["metric_bytes_floor"], summ
        assert len(r["cells"]) == 20 and len(r["relations"]) == 2
        for c in r["cells"]:
            launches = c["kernel_launches"]
            if "bucketed" in MODES[c["mode"]]["compression"]:
                assert launches.get("cast_copy", 0) >= 1, (c["mode"],
                                                           launches)
            if c["optimizer"] == "lars" and c["mode"] not in (
                    "gspmd", "perleaf"):
                assert launches.get("seg_sq_partials", 0) >= 1 and \
                    launches.get("lars_update", 0) >= 1, (c["mode"],
                                                          launches)
    for c in rep["full"]["cells"]:
        assert c["convolution_backward"] == \
            c["convolution_backward_in_backward"] == RESNET50_CONVS, c["mode"]
    for c in rep["reduced"]["cells"]:
        want = jax_cells[(c["mode"], c["optimizer"])]
        got_q, want_q = _qualifying(c), _qualifying(want)
        got_s = c["passes"]["collectives"]["summary"]["gradient_sync"]
        want_s = want["passes"]["collectives"]["summary"]["gradient_sync"]
        if c["mode"] in AUDIT_COUNTED:
            assert (got_q, got_s) == (want_q, want_s), (c["mode"], got_q,
                                                        want_q)
        else:
            log(f"  reduced {c['mode']}/{c['optimizer']}: qualifying "
                f"{got_q} against AUDIT.json's {want_q} (XLA's combiner "
                f"merges the JAX package's; not compared)")
            assert got_s == want_s, (c["mode"], got_s, want_s)
    want_rel = {r["optimizer"]: r["expected_shrink_bytes"]
                for r in jax_rec["relations"]}
    got_rel = {r["optimizer"]: r["expected_shrink_bytes"]
               for r in rep["reduced"]["relations"]}
    log(f"  ZeRO expected shrink (reduced, 8 workers) {got_rel}, "
        f"AUDIT.json's {want_rel}")
    assert got_rel == want_rel, (got_rel, want_rel)
    out["relations"] = {n: rep[n]["relations"] for n in ("full", "reduced")}
    return out, rep["full"]["cells"]


def audit_fusion_phase(torch):
    """The fusion report (``analysis/passes/fusion.py``) on the card: one
    BN site's forward and backward recorded through the fused kernels
    and through the unfused PyTorch ops (``core/batchnorm.py``), at
    ResNet-50's first stage-1 site (32 x 56 x 56 x 64, f32, ReLU). The
    fused site must make fewer activation-sized reduction passes and no
    more activation-sized writes. Returns the report."""
    from repro_torch.analysis.op_trace import record
    from repro_torch.analysis.passes.fusion import fusion_report
    from repro_torch.core.batchnorm import bn_apply_stats, bn_batch_stats
    from repro_torch.kernels.fused_bn import fused_bn_train
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(30)
    x = torch.randn(32, 56, 56, 64, generator=gen, device=dev)
    x.requires_grad_()
    scale = torch.ones(64, device=dev, requires_grad=True)
    bias = torch.zeros(64, device=dev, requires_grad=True)
    traces = {}
    for name in ("fused", "unfused"):
        with record("cuda") as trace:
            if name == "fused":
                y = fused_bn_train(x, scale, bias, relu=True)[0]
            else:
                mean, var = bn_batch_stats(x)
                y = torch.relu(bn_apply_stats(x, mean, var, scale, bias))
            y.sum().backward()
        torch.cuda.synchronize()
        traces[name] = trace
    rep = fusion_report(traces["fused"], traces["unfused"], x.numel())
    log(f"  fusion at one BN site: reductions {rep['reduction_ops_per_site']}"
        f", activation writes {rep['activation_writes_per_site']}, fused "
        f"launches {traces['fused'].launches}")
    assert rep["collapsed"], rep
    return rep


def audit_kernel_phase(torch, full_cells):
    """The audit's kernels at the full-width cells' shapes, 8 workers,
    the f16 wire in 4 MiB buckets: ``cast_copy`` as one pack and one
    unpack of the bucketed cell's stream (the ZeRO cells' unpack takes a
    worker's shard); ``seg_sq_partials`` and ``lars_update`` over the
    bucketed stream-LARS cell's whole stream and the ZeRO cell's shard,
    each against its plain version (bitwise but the sums, held to the
    float64 sum) with its bound and library call. Returns the records by
    kernel and shape."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.bucketing import (local_shard, plan_buckets,
                                                   segment_ids_stream)
    from repro_torch.kernels import bucket_ops as bo
    from repro_torch.kernels import fused_update as fu
    from repro_torch.models import build_model
    from repro_torch.optim.stream import trust_mask_segments
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    cells = {(c["mode"], c["optimizer"]): c for c in full_cells}
    model = build_model(get_config("resnet50"), device="cpu")
    params = {k: p.detach() for k, p in model.named_parameters()}
    plan = plan_buckets(params, 4 * 2 ** 20, "f16", align=AUDIT_WORKERS)
    n = plan.padded_total
    assert n == cells[("bucketed", "lars")]["info"]["padded_total"], n
    out = {}
    f16, f32 = torch.float16, torch.float32
    for name, elems in (("stream", n), ("shard", n // AUDIT_WORKERS)):
        x = torch.randn(elems, generator=gen, device=dev)
        w = x.to(f16)
        _bitwise(f"cast_copy audit {name} pack", bo.pack_cast(x, f16), w)
        _bitwise(f"cast_copy audit {name} unpack", bo.unpack_cast(w),
                 w.to(f32))
        rec = {"elements": elems,
               "ms": time_ms(torch, lambda: bo.pack_cast(x, f16))
               + time_ms(torch, lambda: bo.unpack_cast(w)),
               "plain_ms": time_ms(torch, lambda: bo.PLAIN["cast_copy"](
                   x, f16)) + time_ms(torch, lambda: bo.PLAIN["cast_copy"](
                       w, f32)),
               "library_ms": time_ms(torch, lambda: x.to(f16))
               + time_ms(torch, lambda: w.to(f32)),
               "max_abs_err": 0.0}
        rec["bound_ms"], rec["bound_by"] = bound(2 * 6 * elems, 0)
        out[f"cast_copy/{name}"] = rec
        del x, w
    seg_all = torch.from_numpy(segment_ids_stream(plan)).to(dev)
    mask = torch.from_numpy(trust_mask_segments(params, plan)).to(dev)
    n_seg = mask.numel()
    trust = torch.where(mask, torch.rand(n_seg, generator=gen, device=dev)
                        * 1e-2, 1.0)
    eta, mu1, decay = 0.1, 0.9, 1e-4
    for name, cut in (("stream", None), ("shard", 0)):
        def part(t):
            return t if cut is None else local_shard(t, plan, AUDIT_WORKERS,
                                                     cut)
        p = part(torch.randn(n, generator=gen, device=dev) * 0.05)
        g = part(torch.randn(n, generator=gen, device=dev) * 1e-3)
        d = part(torch.randn(n, generator=gen, device=dev) * 1e-3)
        seg = part(seg_all).contiguous()
        p, g, d = p.contiguous(), g.contiguous(), d.contiguous()
        wd = torch.full_like(p, decay)
        m = p.numel()
        got = fu.fused_segment_sq_partials(p, g, wd, seg, n_seg)
        plain = fu.PLAIN["seg_sq_partials"](p, g, wd, seg, n_seg)
        p64, ge64 = p.double(), g.double() + wd.double() * p.double()
        want = torch.zeros(2, n_seg, dtype=torch.float64, device=dev)
        want.index_add_(1, seg.long(), torch.stack([p64 * p64, ge64 * ge64]))
        rel = ((got.double() - want).abs() / want.clamp_min(1e-300)).max()
        assert rel.item() <= 1e-5, (name, rel.item())
        kern, ref = [p.clone(), d.clone()], [p.clone(), d.clone()]
        fu.fused_lars_update(g, *kern, wd, seg, trust, eta, mu1)
        fu.PLAIN["lars_update"](g, *ref, wd, seg, trust, eta, mu1)
        _bitwise(f"lars_update audit {name} p", kern[0], ref[0])
        _bitwise(f"lars_update audit {name} d", kern[1], ref[1])
        sq = torch.stack([p * p, (g + wd * p).square()])
        seg64 = seg.long()
        out[f"seg_sq_partials/{name}"] = {
            "elements": m, "segments": n_seg,
            "ms": time_ms(torch, lambda: fu.fused_segment_sq_partials(
                p, g, wd, seg, n_seg)),
            "plain_ms": time_eager_ms(torch, lambda: fu.PLAIN[
                "seg_sq_partials"](p, g, wd, seg, n_seg)),
            # one call of the same sums: index_add_ of the squares
            "library_ms": time_ms(torch, lambda: torch.zeros(
                2, n_seg, device=dev).index_add_(1, seg64, sq)),
            "max_abs_err": (got - plain).abs().max().item(),
            "rel_err_f64": rel.item()}
        (out[f"seg_sq_partials/{name}"]["bound_ms"],
         out[f"seg_sq_partials/{name}"]["bound_by"]) = bound(
            16 * m + 8 * n_seg, SEG_SQ_FLOPS * m)
        out[f"lars_update/{name}"] = {
            "elements": m, "segments": n_seg,
            "ms": time_ms(torch, lambda: fu.fused_lars_update(
                g, kern[0], kern[1], wd, seg, trust, eta, mu1)),
            "plain_ms": time_ms(torch, lambda: fu.PLAIN["lars_update"](
                g, ref[0], ref[1], wd, seg, trust, eta, mu1)),
            "library_ms": None, "max_abs_err": 0.0}
        (out[f"lars_update/{name}"]["bound_ms"],
         out[f"lars_update/{name}"]["bound_by"]) = bound(
            28 * m + 4 * n_seg, LARS_FLOPS * m)
    for k, r in out.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f}"
        log(f"  {k:24s} n={r['elements']:9d} {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, library {lib}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']})")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for the per-shape kernel table")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few main-path steps "
                         "(torch.profiler: device busy share, top ops)")
    ap.add_argument("--turns", type=int, default=0,
                    help="then run the main paths again in turns "
                         "(2, 5, 6, 2 pre-made, 1, 1, 2 pre-made, 6, 5, 2) "
                         "this many times, to compare their step times "
                         "within one run")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's sources are not at {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import multiprocessing
    multiprocessing.set_forkserver_preload(list(WORKER_PRELOAD))
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.distributed import shutdown
    from repro_torch.kernels import _build
    from repro_torch.kernels import bucket_ops as bo
    from repro_torch.kernels import fused_bn as fb
    from repro_torch.kernels import fused_input as fi
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import rmsnorm as rn
    libs = (fb, fu, bo, fi, fa, rn)

    t_all = time.perf_counter()
    card = nvidia_smi_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    built = _build.build(SOURCES)
    log(f"[2] built {sorted(built)} in {time.perf_counter() - t0:.1f}s")

    cfg = get_config("resnet50")
    t0 = time.perf_counter()
    log("[3] kernels vs plain versions at the batch-32 BN-site shapes")
    shape_rows = []
    totals, pair = kernel_phase(torch, fb, cfg, shape_rows)
    log(f"  per-step site pair (bf16): fwd {pair['fwd_ms']:.3f} ms vs "
        f"aten::native_batch_norm {pair['fwd_library_ms']:.3f} ms; bwd "
        f"{pair['bwd_ms']:.3f} ms vs its backward "
        f"{pair['bwd_library_ms']:.3f} ms, with threshold_backward at the "
        f"ReLU sites {pair['bwd_library_same_ms']:.3f} ms")
    log(f"  bn_stats {totals['bn_stats']['ms']:.3f} ms vs "
        f"torch.batch_norm_stats {totals['bn_stats']['batch_norm_stats_ms']:.3f}"
        f" ms; at the sites without ReLU or residual: bn_bwd_sums "
        f"{pair['plain_sites_bwd_sums_ms']:.3f} ms vs "
        f"batch_norm_backward_reduce {pair['backward_reduce_ms']:.3f} ms, "
        f"bn_bwd_dx {pair['plain_sites_bwd_dx_ms']:.3f} ms vs "
        f"batch_norm_backward_elemt {pair['backward_elemt_ms']:.3f} ms "
        f"({time.perf_counter() - t0:.1f}s)")
    division = division_check(torch)
    log(f"  ATen t / m on the card, elements whose bits differ: {division}")

    t0 = time.perf_counter()
    log("[3b] fused update, wire cast and fused input vs plain versions")
    params_cpu = model_params(cfg)
    leaves = model_leaves(params_cpu)
    wd = OptimizerConfig().weight_decay
    new = {}
    new["hybrid_update"], total = update_phase(torch, leaves, wd)
    new["hybrid_update"]["host"] = update_host_phase(torch, params_cpu)
    new["cast_copy"] = cast_phase(torch, total, [n for _, n, _ in leaves])
    new.update(input_phase(torch, cfg))
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("[3c] stream-LARS kernels vs plain versions and float64 sums")
    lars_totals, lars_cases = lars_phase(torch, params_cpu, wd)
    new.update(lars_totals)
    del params_cpu
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("[3d] flash_attention and rmsnorm vs plain versions")
    lm_totals, lm_cases = lm_kernel_phase(torch)
    floor = launch_floor_phase(torch)
    rms = lm_totals["rmsnorm"]
    rms["launch_floor_ms"] = floor["decode_grid_ms"]
    rms["order_rows_compared"] = rmsnorm_order_phase(torch)
    log(f"  rmsnorm at a decode site {rms['decode_launch_ms'] * 1e3:.2f} "
        f"us a launch, {rms['decode_launch_ms'] / floor['decode_grid_ms']:.2f}"
        f"x the empty kernel on its grid; F.rms_norm at the same "
        f"{SERVE_BATCH} x 2048 bf16 {rms['decode_library_ms'] * 1e3:.2f} us,"
        f" bound {rms['decode_bound_ms'] * 1e3:.4f} us, empty kernel "
        f"{floor['decode_grid_ms'] * 1e3:.2f} us")
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("[3e] gradients through the LM kernels' autograd Functions vs the "
        "plain versions' autograd")
    lm_grads = grad_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("[3f] flash_attention, rmsnorm, hybrid_update and cast_copy at "
        "main paths 9 and 10's shapes vs plain versions")
    slice13 = slice13_kernel_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("[3f] (slice 14) flash_attention (bf16, f32) at mixtral-8x7b's "
        "window and llama4-maverick's 40 / 8 heads and (bf16) at main paths "
        "12 and 13's mixtral shapes, rmsnorm at d 4,096 and 5,120, "
        "hybrid_update and cast_copy at main path 13's leaves vs plain "
        "versions")
    slice14 = slice14_kernel_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("[3g] flash_attention (bf16, f32) at main path 14's prefills "
        "(phi-3-vision Dh 96 over 1,600 rows, zamba2-7b Dh 112 in its "
        "4,096-token window, whisper-tiny's non-causal encoder and cross "
        "attention over 1,500 frames and its causal decoder) and (bf16) "
        "at main path 15's training shapes, rmsnorm at d 3,072, 3,584, "
        "7,168 and 2,048 vs plain versions")
    slice15 = slice15_kernel_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    log("[3h] flash_attention (bf16) at main path 17's worker-local heads "
        "(16 / 4 of llama3.2-1b's 32 / 8, Dh 64), rmsnorm at its rows, "
        "hybrid_update over one TP worker's shards vs plain versions")
    slice17 = slice17_kernel_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    log("[3i] flash_attention (bf16) at main paths 18 and 19's "
        "worker-local heads (mixtral 16 / 4, maverick 20 / 4, phi-3-vision "
        "16 at Dh 96, zamba2 16 at Dh 112, whisper-tiny 3 of 6), rmsnorm "
        "at their rows (zamba2's and xLSTM's whole-row out_norm), "
        "hybrid_update over one worker's shards of each config they train "
        "vs plain versions")
    slice18 = slice18_kernel_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    log("[3j] flash_attention (bf16) at main path 21's prefill "
        "(granite-34b's 4,096 tokens whole, 48 and 24 heads on one kv "
        "head) and main path 20's worker-local heads, rmsnorm at main "
        "path 20's rows, hybrid_update over one FSDP x TP x ZeRO-1 "
        "worker's shards vs plain versions")
    slice19 = slice19_kernel_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log(f"[4] main path 1: ResNet-50 full width, batch {BATCH}, bf16, fused "
        f"BN, {STEPS} steps + 1 eval batch")
    _, stats, live = main_path(torch, libs, cfg, STEPS)
    log(f"  ({time.perf_counter() - t0:.1f}s)")
    if args.profile:
        log("[4p] profile of the main path")
        stats["profile"] = profile_phase(torch, *live)

    t0 = time.perf_counter()
    log("[4b] reference: reduced ResNet f32, fused vs unfused on the card")
    ref = reference_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    try:
        t0 = time.perf_counter()
        log(f"[6] main path 2: the paper's DP step at world size 1 (NCCL), "
            f"ResNet-50 full width, batch {BATCH}, bf16, fused BN, "
            f"bf16+bucketed, fused update, fused input, 4 data workers, "
            f"{STEPS} steps + 1 eval batch")
        launches, stats2, live2 = dp_main_path(torch, libs, cfg, STEPS)
        log(f"  ({time.perf_counter() - t0:.1f}s)")
        if args.profile:
            log("[6p] profile of main path 2")
            stats2["profile"] = profile_phase(torch, *live2)
        del live2

        t0 = time.perf_counter()
        log("[6b] reference: reduced ResNet f32, DP step, new kernels on "
            "vs off")
        ref2 = dp_reference_phase(torch)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

        builds = {"path5": {"sync_bn": True},
                  "path6": {"overlap_comm": True,
                            "bucket_bytes": OVERLAP_BUCKET_MIB << 20}}
        order = ("path2", "path5", "path6", "path2_premade", "path1",
                 "path1", "path2_premade", "path6", "path5", "path2")
        turns = {f"{k}_median_wall_ms": [] for k in order}
        if args.turns:
            log(f"[7] main paths in turns {order} x {args.turns}")
        for _ in range(args.turns):
            for which in order:
                if which == "path1":
                    st = main_path(torch, libs, cfg, STEPS)[1]
                else:
                    st = dp_main_path(torch, libs, cfg, STEPS,
                                      premade=which.endswith("premade"),
                                      build=builds.get(which))[1]
                turns[f"{which}_median_wall_ms"].append(st["median_wall_ms"])
        if args.turns:
            log(f"  {turns}")

        t0 = time.perf_counter()
        log(f"[8] main path 3: stream-LARS on the DP step at world size 1 "
            f"(NCCL), ResNet-50 full width, batch {BATCH}, bf16, fused BN, "
            f"bf16+bucketed, lars_ls_poly, fused update, fused input, 4 "
            f"data workers, {STEPS} steps + 1 eval batch")
        launches3, stats3, live3 = dp_main_path(torch, libs, cfg, STEPS,
                                                lars=True)
        log(f"  ({time.perf_counter() - t0:.1f}s)")
        if args.profile:
            log("[8p] profile of main path 3")
            stats3["profile"] = profile_phase(torch, *live3)
        del live3

        t0 = time.perf_counter()
        log("[8b] reference: reduced ResNet f32, stream-LARS DP step with "
            "error feedback, kernels on twice vs the plain stream update")
        ref3 = lars_reference_phase(torch)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

        t0 = time.perf_counter()
        log(f"[10] main path 2 with checkpoints: {CKPT_STEPS} steps, a save "
            f"every {CKPT_EVERY}, one eval batch (best checkpoint); resumed "
            f"from step {CKPT_EVERY} by a fresh Trainer, bitwise against "
            f"the unbroken run (cuDNN deterministic)")
        ckpt_stats = ckpt_phase(torch, libs, cfg)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

        t0 = time.perf_counter()
        log(f"[10b] the sentinel on main path 2: chaos {SENTINEL_CHAOS!r}, "
            f"a save every {CKPT_EVERY}, {SENTINEL_STEPS} steps")
        sentinel_stats = sentinel_phase(torch, libs, cfg)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

        t0 = time.perf_counter()
        log(f"[11] main path 5: main path 2 with sync_bn=True at world size "
            f"1 (NCCL), beside main path 2, {STEPS} steps + 1 eval batch "
            f"each, cuDNN deterministic: bitwise, launches and all-reduces")
        sync_stats, bits2 = sync_bn_phase(torch, libs, cfg)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

        t0 = time.perf_counter()
        log("[11b] cross-worker sums on the card: two processes on the one "
            "card over gloo, reduced ResNet f32, fused BN, sync_bn=True, 3 "
            "steps, card vs CPU")
        sync_cards = sync_bn_cards_phase(torch)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

        t0 = time.perf_counter()
        log(f"[12] main path 6: main paths 2 and 3 with overlap_comm=True "
            f"({OVERLAP_BUCKET_MIB} MiB buckets) at world size 1 (NCCL), "
            f"{STEPS} steps + 1 eval batch each, cuDNN deterministic")
        overlap_stats = overlap_phase(torch, libs, cfg, bits2,
                                      sync_stats["path2"]["median_step_ms"])
        del bits2
        log(f"  ({time.perf_counter() - t0:.1f}s)")

        t0 = time.perf_counter()
        log("[12b] reference: reduced ResNet f32, the overlapped step with "
            "error feedback, kernels on vs the per-leaf step with them off")
        ref6 = overlap_reference_phase(torch)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

        t0 = time.perf_counter()
        log(f"[13] main path 7: ZeRO on the DP step, two processes on the one "
            f"card over gloo, ResNet-50 full width, {BATCH} images a worker, "
            f"bf16, fused BN, bf16+bucketed, fused update, fused input, "
            f"{STEPS} steps + 1 eval batch, beside main path 2's "
            f"configuration at 2 workers (cuDNN deterministic); a save every "
            f"{ZERO_CKPT_EVERY} of {ZERO_CKPT_STEPS} steps, resumed; [13b] "
            f"the reduced ResNet f32: ZeRO + overlap, stream-LARS, "
            f"momentum_sgd and ZeRO + overlap stream-LARS against their "
            f"all-reduce paths")
        zero_stats, launches7 = zero_phase(torch)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

        t0 = time.perf_counter()
        log(f"[14] main path 8: the hierarchical schedule on the DP step, "
            f"four processes on the one card over gloo as a 2x2 layout "
            f"(--mesh 2x2 --comm-plan hier:1), ResNet-50 full width, "
            f"{BATCH} images a worker, bf16, fused BN, bf16+bucketed, fused "
            f"update, fused input, {STEPS} steps + 1 eval batch: (A) "
            f"bucketed + hier, (B) ZeRO + hier, (C) flat at 4 workers "
            f"(cuDNN deterministic); the primitives on the card; [14b] the "
            f"reduced ResNet f32 under hier:1: overlap, error feedback, "
            f"ZeRO + overlap, stream-LARS and momentum_sgd pairs")
        hier_stats, (launches8, launches8_zero) = hier_phase(torch)
        log(f"  ({time.perf_counter() - t0:.1f}s)")
    finally:
        shutdown()

    t0 = time.perf_counter()
    log(f"[9] main path 4: serve() llama3.2-1b full width, batch "
        f"{SERVE_BATCH}, {SERVE_PROMPT}-token prompts, {SERVE_STEPS - 1} "
        f"greedy decode steps, bf16, chunked (flash) attention")
    launches4, stats4 = serve_main_path(torch, libs, args.profile)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("[9b] reference: reduced llama3.2-1b f32, kernels on the card vs "
        "plain versions on the CPU")
    ref4 = serve_reference_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    launches9, stats9 = {}, {}
    for arch, layers, steps in DENSE_SERVE:
        t0 = time.perf_counter()
        depth = "full depth" if layers is None else f"{layers} layers"
        log(f"[15] main path 9: serve() {arch} full width, {depth}, batch "
            f"{SERVE_BATCH}, {SERVE_PROMPT}-token prompts, {steps - 1} "
            f"greedy decode steps, bf16, chunked (flash) attention, weights "
            f"drawn on the card")
        launches9[arch], stats9[arch] = lm_serve_path(torch, libs, arch,
                                                         layers, steps)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log(f"[16] main path 10: {LM_TRAIN_ARCH} trained at full width, batch "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, bf16, flash attention, "
        f"rmsprop_warmup + slow_start, fused update, {LM_TRAIN_STEPS} steps "
        f"+ 1 eval batch through the Trainer: one device, then the DP step "
        f"at world size 1 (NCCL, bf16+bucketed), bitwise")
    launches10, launches10_dp, stats10, ref10_state = lm_train_path(
        torch, libs, args.profile)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("[16b] reference: reduced llama3.2-1b f32 trained 3 steps, kernels "
        "on the card vs plain versions on the CPU")
    ref10 = lm_train_reference_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    log(f"[16c] main path 10 on one device with remat (each layer group "
        f"checkpointed, as the JAX launcher does above 8 layers) and "
        f"without, {REMAT_STEPS} steps + 1 eval batch each: bitwise")
    remat10 = remat_phase(torch, libs)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log(f"[17] main path 11: main path 10's DP step with overlap_comm=True "
        f"at world size 1 (NCCL), full width and depth, {LM_TRAIN_STEPS} "
        f"steps + 1 eval batch, bitwise main path 10")
    launches11, stats11 = lm_overlap_path(torch, libs, ref10_state)
    del ref10_state
    torch.cuda.empty_cache()
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log(f"[17] main path 11 across processes on the one card over gloo, "
        f"{LM_TRAIN_ARCH} full width, {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} "
        f"tokens a worker, bf16, flash, {LM_DP_STEPS} steps, one spawn: 4 "
        f"workers as 2x2 under hier:1 ({LM_DP_LAYERS[4]} layers) ZeRO + "
        f"hier vs bucketed + hier, then 2 of them ({LM_DP_LAYERS[2]} "
        f"layers) ZeRO vs bucketed; [17b] the reduced model in f32 in the "
        f"same processes (overlap, ZeRO, ZeRO + overlap vs bucketed), all "
        f"bitwise")
    lm_dp = lm_dp_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("[17b] the staged LM loss on the card: reduced llama3.2-1b and "
        "llama4-maverick in f32, staged vs loss_fn gradients")
    staged = staged_reference_phase(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    launches12, stats12 = {}, {}
    for arch, layers, prompt, steps, naive in MOE_SERVE:
        t0 = time.perf_counter()
        log(f"[18] main path 12: serve() {arch} full width, {layers} "
            f"layers, batch {SERVE_BATCH}, {prompt}-token prompts, "
            f"{steps - 1} greedy decode steps, bf16, chunked (flash) "
            f"attention, weights drawn on the card leaf by leaf")
        key = f"{arch}_p{prompt}"
        launches12[key], stats12[key] = lm_serve_path(
            torch, libs, arch, layers, steps, prompt=prompt, naive=naive)
        log(f"  ({time.perf_counter() - t0:.1f}s)")
    window_run = stats12["mixtral-8x7b_p4064"]
    assert window_run["cache_len"] < 4064 + 65, window_run["cache_len"]

    ref12 = {}
    for arch in ("mixtral-8x7b", "llama4-maverick-400b-a17b"):
        t0 = time.perf_counter()
        log(f"[18b] reference: reduced {arch} f32, kernels on the card vs "
            f"plain versions on the CPU")
        ref12[arch] = serve_reference_phase(torch, arch, prompt=128)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log(f"[19] main path 13: {MOE_TRAIN_ARCH} trained at full width, "
        f"{MOE_TRAIN_LAYERS} of 32 layers, batch {LM_TRAIN_BATCH} x "
        f"{LM_TRAIN_SEQ} tokens, bf16, flash, {FAMILY_TRAIN_STEPS} steps "
        f"+ 1 eval batch: one device, then the DP step at world size 1 "
        f"(NCCL), bitwise")
    launches13, stats13 = family_train_path(torch, libs, MOE_TRAIN_ARCH,
                                            MOE_TRAIN_LAYERS)
    log(f"  ({time.perf_counter() - t0:.1f}s)")

    launches14, stats14 = {}, {}
    for arch, naive in FAMILY_SERVE:
        t0 = time.perf_counter()
        log(f"[20] main path 14: serve() {arch} whole at full width, batch "
            f"{SERVE_BATCH}, {SERVE_PROMPT}-token prompts, {SERVE_STEPS - 1} "
            f"greedy decode steps, bf16, chunked (flash) attention, weights "
            f"drawn on the card leaf by leaf; one prefill and 4 decode "
            f"steps profiled")
        launches14[arch], stats14[arch] = lm_serve_path(
            torch, libs, arch, None, SERVE_STEPS, naive=naive, profile=True)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

    ref14 = {}
    for arch, _ in FAMILY_SERVE:
        t0 = time.perf_counter()
        log(f"[20b] reference: reduced {arch} f32, kernels on the card vs "
            f"plain versions on the CPU")
        ref14[arch] = serve_reference_phase(torch, arch, prompt=128)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

    launches15, stats15 = {}, {}
    for arch, layers in FAMILY_TRAIN:
        t0 = time.perf_counter()
        depth = "whole" if layers is None else f"at {layers} layers"
        log(f"[21] main path 15: {arch} trained at full width, {depth}, "
            f"batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, bf16, flash, "
            f"{FAMILY_TRAIN_STEPS} steps + 1 eval batch: one device, then "
            f"the DP step at world size 1 (NCCL), bitwise")
        launches15[arch], stats15[arch] = family_train_path(torch, libs,
                                                            arch, layers)
        log(f"  ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log(f"[22] main path 16: ResNet-50 full width under --dp-mode gspmd "
        f"--mesh 2x1 --fused-bn --use-fused-kernel, two processes on the "
        f"one card over gloo, {BATCH} images a worker, bf16, "
        f"{GSPMD_STEPS} steps (BN over the global batch), against one "
        f"process on the {GSPMD_WORKERS * BATCH}-image batch and main path "
        f"5's step at the same workers (cuDNN deterministic)")
    launches16, stats16 = gspmd_resnet_path(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    log(f"[23] main path 17: {LM_TRAIN_ARCH} at full size under --dp-mode "
        f"gspmd --mesh 1x2 (tensor parallel 2), remat on, bf16, flash on "
        f"each worker's heads, {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, "
        f"{GSPMD_STEPS} steps, two processes on the one card over gloo")
    launches17, stats17 = gspmd_lm_path(
        torch, stats10["one_device"]["losses"][0])
    log(f"  ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    log(f"[24] main path 18: MoE under --dp-mode gspmd --mesh 1x2 (EP 2), "
        f"two processes on the one card over gloo, bf16, flash on each "
        f"worker's heads: {MOE_TRAIN_ARCH} trained at {MOE_TRAIN_LAYERS} of "
        f"32 layers, {GSPMD_TRAIN_STEPS} steps of main path 13's batch "
        f"(the first step's routing replayed from one device); the GSPMD "
        f"prefill of main path 12's requests and {GSPMD_DECODE_STEPS} "
        f"greedy decode steps for mixtral-8x7b at 4 of 32 layers and "
        f"llama4-maverick at one group (the routing replayed)")
    launches18, stats18 = gspmd_family_path(
        torch, 18, {MOE_TRAIN_ARCH: stats13["one_device"]["losses"][0]})
    log(f"  ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    log(f"[25] main path 19: phi-3-vision, zamba2-7b, xlstm-350m and "
        f"whisper-tiny under --dp-mode gspmd --mesh 1x2 (TP 2) at main "
        f"path 15's depths (zamba2 served at 6 layers), two processes on "
        f"the one card over gloo, bf16: "
        f"{GSPMD_TRAIN_STEPS} steps of main path 15's batch, then the GSPMD "
        f"prefill of main path 14's requests and {GSPMD_DECODE_STEPS} "
        f"greedy decode steps")
    launches19, stats19 = gspmd_family_path(
        torch, 19, {arch: stats15[arch]["one_device"]["losses"][0]
                    for arch, _ in FAMILY_TRAIN})
    log(f"  ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    log(f"[26] main path 20: {FSDP_ARCH} at full width, {FSDP_LAYERS} of "
        f"48 layers, under its own policy (FSDP over 'data', Megatron TP "
        f"over 'model', ZeRO-1, the bf16 wire, remat), --mesh 2x2, four "
        f"processes on the one card over gloo, bf16, flash, "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, {FSDP_STEPS} steps; "
        f"against one device, without fsdp_params, with microbatches=2 "
        f"and with LARS")
    launches20, stats20 = gspmd_fsdp_path(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    log(f"[27] main path 21: {SP_ARCH} at full width, {SP_LAYERS} of 88 "
        f"layers, served under its batch-1 prefill policy (TP, sequence "
        f"parallelism, the cache's positions on 'model'), --mesh 1x2, two "
        f"processes on the one card over gloo: one {SP_PROMPT}-token "
        f"prompt, a bf16 prefill and {SP_DECODE} teacher-forced decode "
        f"steps against one device's, the f32 prefill as the witness")
    launches21, stats21 = gspmd_sp_path(torch)
    log(f"  ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    log(f"[28] the audit of the recorded step: {AUDIT_WORKERS} processes on "
        f"the one card over gloo, every sync mode x {{sgd, lars}} (flat "
        f"{AUDIT_WORKERS}x1, hierarchical 2x{AUDIT_WORKERS // 2}), f32, "
        f"the f16 wire, global batch 16: full ResNet-50 against the JAX "
        f"package's contracts, the reduced one against AUDIT.json; the "
        f"audit's kernels at the full cells' shapes")
    audit, audit_cells = audit_phase(torch)
    audit["kernels"] = audit_kernel_phase(torch, audit_cells)
    audit["fusion"] = audit_fusion_phase(torch)
    audit_launches = {}
    for c in audit_cells:
        for k, v in c["kernel_launches"].items():
            audit_launches[k] = audit_launches.get(k, 0) + v
    del audit_cells
    log(f"  launches over the 20 full cells' recorded steps (rank 0) "
        f"{audit_launches} ({time.perf_counter() - t0:.1f}s)")
    launches5 = sync_stats["path5_launches"]
    launches6 = overlap_stats["path6_launches"]
    by_path = {k: {"path2": launches[k], "path3": launches3[k],
                   "path4": launches4[k], "path5": launches5[k],
                   "path6": launches6[k],
                   "path6_lars": overlap_stats["path3_overlap_launches"][k],
                   "path7": launches7[k], "path8": launches8[k],
                   "path8_zero": launches8_zero[k],
                   **{f"path9_{a}": launches9[a][k] for a in launches9},
                   "path10": launches10[k], "path10_dp": launches10_dp[k],
                   "path11": launches11[k],
                   **{f"path11_{n}w_{name}": lm_dp[n][0]["full"][name][
                       "launches"][k] for n in lm_dp
                      for name in lm_dp[n][0]["full"]},
                   **{f"path12_{a}": launches12[a][k] for a in launches12},
                   "path13": launches13["one_device"][k],
                   "path13_dp": launches13["dp"][k],
                   **{f"path14_{a}": launches14[a][k] for a in launches14},
                   **{f"path15_{a}_{run}": launches15[a][run][k]
                      for a in launches15 for run in launches15[a]},
                   "path10_remat": remat10["remat"]["launches"][k],
                   "path10_no_remat": remat10["no_remat"]["launches"][k],
                   "path16": launches16[k], "path17": launches17[k],
                   "path18": launches18.get(k, 0),
                   "path19": launches19.get(k, 0),
                   "path20": launches20.get(k, 0),
                   "path21": launches21.get(k, 0),
                   "audit": audit_launches.get(k, 0)}
               for k in launches}
    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                "launches_by_path": by_path[k],
                "max_abs_err": totals[k]["max_abs_err"],
                "ms": totals[k]["ms"], "plain_ms": totals[k]["plain_ms"],
                "bound_ms": totals[k]["bound_ms"], "bound_by": "bytes",
                "library_ms": totals[k]["library_ms"]} for k in KERNELS]
    for k, (src, replaces) in {**NEW_KERNELS, **LARS_KERNELS}.items():
        t = new[k]
        kernels.append({
            "name": k, "route": "cuda", "source": CSRC + src,
            "replaces": replaces,
            "launches": (launches3 if k in LARS_KERNELS else launches)[k],
            "launches_by_path": by_path[k],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        if k == "hybrid_update":  # the earlier design, timed in this run
            kernels[-1]["per_leaf_ms"] = t["per_leaf_ms"]
            # _kernel_wd through the decay-stream entry, at main path 7's
            # shard (one launch a step there)
            kernels[-1]["zero_shard"] = {
                key: zero_stats["hybrid_update_shard"][key]
                for key in ("elements", "ms", "plain_ms", "bound_ms")}
    for k, (src, replaces) in LM_KERNELS.items():
        t = lm_totals[k]
        kernels.append({
            "name": k, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "launches": launches4[k],
            "launches_by_path": by_path[k],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "unit": t["unit"]})
    kernels[-1]["launch_floor_ms"] = floor["decode_grid_ms"]
    assert len(kernels) == 12, len(kernels)
    # this slice's shapes of the four kernels its paths run (phase 3f)
    for rec in kernels:
        if rec["name"] in slice13:
            rec["slice13"] = slice13[rec["name"]]
        if rec["name"] in slice14:
            rec["slice14"] = slice14[rec["name"]]
        if rec["name"] in slice15:
            rec["slice15"] = slice15[rec["name"]]
        if rec["name"] in slice17:
            rec["slice17"] = slice17[rec["name"]]
        if rec["name"] in slice18:
            rec["slice18"] = slice18[rec["name"]]
        if rec["name"] in slice19:
            rec["slice19"] = slice19[rec["name"]]
        audit_k = {shape.split("/")[1]: t for shape, t in
                   audit["kernels"].items()
                   if shape.split("/")[0] == rec["name"]}
        if audit_k:
            rec["audit"] = audit_k
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_kernels.json"),
                  "w") as f:
            json.dump({"card": card, "shapes": shape_rows, "pair": pair,
                       "kernels": kernels, "new_kernels": new,
                       "main_path": stats, "main_path_2": stats2,
                       "main_path_3": stats3, "lars_cases": lars_cases,
                       "reference": ref, "reference_2": ref2,
                       "reference_3": ref3, "turns": turns,
                       "lm_kernels": lm_totals, "lm_cases": lm_cases,
                       "lm_grads": lm_grads, "launch_floor": floor,
                       "main_path_4": stats4, "reference_4": ref4,
                       "checkpoint": ckpt_stats,
                       "sentinel": sentinel_stats,
                       "sync_bn": sync_stats, "sync_bn_cards": sync_cards,
                       "overlap": overlap_stats, "reference_6": ref6,
                       "zero": zero_stats, "hierarchical": hier_stats,
                       "division": division, "slice13_kernels": slice13,
                       "main_path_9": stats9, "main_path_10": stats10,
                       "reference_10": ref10, "slice14_kernels": slice14,
                       "main_path_11": {"overlap": stats11,
                                        "processes": lm_dp},
                       "staged": staged, "main_path_12": stats12,
                       "reference_12": ref12, "main_path_13": stats13,
                       "slice15_kernels": slice15, "main_path_14": stats14,
                       "reference_14": ref14, "main_path_15": stats15,
                       "slice17_kernels": slice17, "remat_10": remat10,
                       "main_path_16": stats16,
                       "main_path_17": stats17,
                       "slice18_kernels": slice18,
                       "main_path_18": stats18,
                       "main_path_19": stats19,
                       "slice19_kernels": slice19,
                       "main_path_20": stats20,
                       "main_path_21": stats21,
                       "audit": audit}, f,
                      indent=1)
    log(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
