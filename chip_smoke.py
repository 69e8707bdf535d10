#!/usr/bin/env python3
"""Drive the repro_torch serving and training paths on one NVIDIA card and
check them.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``--prev DIR`` names another checkout (e.g. the parent commit's tree,
unpacked with ``git archive``): its ``ts_decay``, ``stcf_support`` and
``chunk_scatter`` sources are built into a library of their own, checked
against this tree's and timed in turns with them (old, new, new, old) in
the kernel phase.

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
and then, in order (phases 1-2 the time-surface path, 3-4 the LM path,
5 the vision heads and labeled ingest on the time-surface path, 6 the
analog-fidelity reads, the streaming runtime and the ``sweep`` CLI, 7 the
elastic slot pool and live migration, 8 the slot pool over several
shards, 9 the slot pool over several cards where more than one is
visible, 10 the paper's reconstruction and classification protocols
trained on the card, 11 the LM trainer on the card, 12 the dense LM
family on the card, 13 the hybrid and MoE LM families, 14 the three
time-surface examples and the paper's ``isc-qvga`` array, 15 the LM
trainer over a mesh of cards, 16 LM serving over a mesh, 17 the capacity
model and roofline against them; phase 8 (a) and
phase 9's loops run straight after phase 2, while phase 1's products
are held to compare against):

1. **Engine** -- the time-surface path: a ``TimeSurfaceEngine`` of 64 slots of
   240x320 pixels and 2 polarities (chunks of 2048 events, eDRAM decay)
   with 64 attached sensors fed from seeded synthetic DND21-like scenes,
   served for 10 deadlines of 10 ms.  Each deadline runs ``serve_step``
   twice, on the two half-window bursts, with the FRAME spec (surface,
   mask, STCF support, 4-bit count, EBBI): a dense fill, then an
   incremental re-read of the dirty tiles.  The kernels' launch counters
   are zeroed just before and read just after.  Checks: incremental ==
   dense read bitwise; the engine's surface == ``ops.ts_decay`` of SAEs
   built independently with ``time_surface.sae_update``, bitwise; the
   SAE, counts, ``t_last`` and ``n_events`` == a CPU engine's on the same
   events, bitwise; every kernel of the path launched.
2. **Kernels** -- each kernel at the engine's full width on the engine's
   own state and a 10 ms push of ~2 M events, held against its plain
   PyTorch version on the card (decay values and masks bitwise, counts
   exact away from the comparator threshold, scatter bitwise), and timed
   with CUDA events (median over launches, L2 flushed before each) beside
   its plain version, a one-call PyTorch yardstick where one exists (TF32
   off), and the least time the card could take (bytes over 3.35 TB/s,
   operations over 67 TFLOP/s float32, the larger).  Besides:
   ``ts_decay`` with per-cell (H, W) parameter planes bitwise at the
   pool's shape; the division gate (``decay.cuh``'s corrected-reciprocal
   quotient against ``__fdiv_rn``: 0 mismatches over all 2^32 dividends
   of each of 9 taus and 2^32 random triples); ``chunk_scatter`` bitwise on duplicate-heavy traffic (90 % of the
   events on 8 cells, rows of 5,000 slots, out-of-range ids) at P = 2
   and at P = 1, its time without the L2 flush and without the dirty
   marks and counter plane, and the atomics per event it issues.
3. **LM** -- the Mamba-2 token-serving path: ``ServeEngine`` on
   mamba2-2.7b at full width and depth (d_model 2560, 80 SSD heads x 64,
   state 128, vocab 50280 padded to 50432, 64 layers, float32 master
   weights drawn on the card from ``PRNGKey(0)``, bf16 activations)
   serves 8 requests with seeded prompt lengths in 1024-2048 (left-padded,
   so at most 16 SSD chunks) and 32 greedy tokens each, after one warm-up
   serve.  The counters are zeroed just before and read just after.
   Prints prefill tokens/s, decode ms per step, and from one more prefill
   and decode step under ``torch.profiler`` their device time by op, the
   device's idle share and the share of a prefill spent in ``decay_scan``.  Checks: ``decay_scan`` launched n_layers times by the
   prefill and never by a decode step; every logit finite; every token
   below ``vocab``; then, on the same model at 2 layers in float32, the
   card against the CPU port (last logits and states within rtol = 1e-4,
   atol = 1e-4 x max(1, max|CPU|)) and the chunked prefill against
   prefill of all but the last token plus one recurrent ``decode_step``
   (the same band).
4. **decay_scan** -- the kernel at the prefill's shapes (8, chunks,
   655,360) against its plain version on the card, bitwise, with and
   without ``s0``, and timed like the others (no one PyTorch call
   computes this recurrence, so it has no yardstick).  Its backward
   ``decay_scan_bwd`` at the training microbatch's shape (1, 16,
   655,360) and the prefill's, with and without ``s0`` and the final
   state's gradient: bitwise against ``decay_scan_bwd_ref``, equal in
   value to autograd of ``decay_scan_ref`` on the card (autograd holds
   +0 where the kernel holds -0 on the cells it sums into a zero buffer;
   counted), timed at the training shape beside its plain version and
   its bound.
5. **Heads and labels** -- the engine phase's configuration and traffic
   served through ``serve_step`` with the FRAME+heads spec: FRAME, a
   second ``Surface(mode="ideal", tau=5 ms)`` named ``fast``,
   ``logits = Classify(inputs=("surface", "fast"), n_classes=10,
   width=32)`` on weights drawn on the CPU from ``PRNGKey(11)`` and
   registered under a key, and ``labels = Denoise()``; counters zeroed
   just before, read just after.  Prints the step p50/p99 and the
   ``Classify`` head's own time (CUDA events).  Checks: every logit
   finite; ``read`` == ``read_many([heads spec, FRAME])`` bitwise for
   every product; ``labels`` == ``stcf >= stcf_threshold`` bitwise; the
   card's logits for 4 slots == the CPU port's ``cnn_apply`` on the
   card's surfaces copied to the host (rtol = 1e-4, atol = 1e-4 x
   max(1, max|CPU|), float32, TF32 off); the three time-surface kernels
   launched.  Then one 10 ms push of 8 sensors through ``push_labeled``
   on the card and on a CPU engine: supports equal wherever no compared
   cell reads within 2 ULP of V_tw (the excepted events counted);
   sensor 0's labels == the offline ``stcf_chunked`` at chunk 2048 on
   the card, bitwise; ``roc_curve`` AUC against the driving scene's
   ground truth, card vs CPU, within 1e-6; events/s of the labeled push.
   Last, the pool's ``TsQuantized(n_bits=16, tick=1 ms)`` read within 2
   ULP of the plain ``ts_wrapped_read_ref`` on the card.
6. **Analog fidelity and the stream** -- the engine phase's pool after one
   10 ms push of all 64 sensors, read with the sweep's spec (analog
   surface, analog ``Stcf``, ``Denoise``, ``Classify`` of 4 classes at
   width 16) at ``analog_3d`` and ``analog_2d``.  Checks: sigma = 0 ==
   the digital read bitwise, every product; a repeated read at the same
   (step, generations) bitwise; a new step draws other noise; the first
   8 sensors against a CPU engine fed the same words (surfaces within 8
   ULP, STCF counts and labels equal outside the comparator band, logits
   within 1e-4 x max(1, max|CPU|)); ``ts_decay`` on the virtual SAE
   within 2 ULP and the mask-form ``stcf_support`` on the analog mask
   bitwise against their plain versions, and ``chunk_scatter`` on one
   ring-staged push bitwise.  Times ``cell_eps``, the analog and digital
   reads (CUDA events) and the ring against the host-staged push.  Then
   ``StreamRuntime`` over the pool through ``events.replay``: every third
   sensor in the ``gesture`` tier on the analog_3d sweep spec, the rest
   ``telemetry`` on FRAME, the scene words offered in 2 substeps per 10
   ms deadline for 10 deadlines, ``drop_oldest``, pipelined, ring on;
   counters zeroed just before and read just after.  Checks: the digests
   replay bitwise through the synchronous oracle on the card; the same
   run with the ring off gives the same digests; each tier conserves its
   events; the three kernels launched.  Prints events/s, readout latency
   p50/p99 per tier, modeled energy per event per mode, and one step
   under ``torch.profiler``.  Last, ``python -m repro_torch.launch.serve
   sweep --hw 120x160 --sensors 4 --duration 0.06 --cmem 10,20
   --retention 12,24`` in a subprocess on the card: its three verdicts
   must hold.
7. **Fleet** -- an elastic pool on the card: ``TimeSurfaceEngine`` of
   240x320, 2 polarities, chunks of 2048, eDRAM, ``slot_bucket = n_slots
   = 21`` (the ``--migrate-demo`` rule ``max(2, sensors // 3)`` for 64
   sensors), under ``StreamRuntime`` with ``elastic``, ``shrink_watermark
   = 0.9``, ``shard_budget = 320``, ``shard_barrier_every = 4``,
   ``drop_oldest``, pipelined, ring on, telemetry on FRAME.  It replays
   ``fleet_scene_feeds(240, 320, 0.1, 64, n_moves=4)``: three attach
   waves grow the pool 21 -> 42 -> 63 -> 84, a batch detach of 20
   sensors shrinks it to 63 with compaction, and four sensors migrate
   live (one on the analog, head-bearing gesture tier), over 10
   deadlines of 10 ms; counters zeroed just before and read just after.
   Checks: the digests replay bitwise through the synchronous oracle on
   the card, which derives the logged compaction moves; the log holds
   >= 2 grows, >= 1 shrink with >= 1 move and >= 4 migrates; each tier
   conserves its events; the three kernels launched; cached
   ``serve_step`` == dense read bitwise after a grow, a migrate and a
   shrink; the same feeds at 60x80 on the card and on a CPU engine give
   equal action logs, counters, tier counters and final SAE bits and
   counts.  Times one grow (21 slots), one migrate and one shrink with
   compaction (CUDA events and the host clock).  Prints events/s and
   p50/p99 per tier beside phase 6's.  Last, ``python -m
   repro_torch.launch.serve stream --migrate-demo --hw 48x64 --duration
   0.06 --deadline 0.005`` in a subprocess on the card: its oracle gate
   must pass.
8. **Shards** -- the slot pool over several shards, every shard on the
   one card with tensors of its own (``make_host_mesh(n, devices=[card])``,
   the code a multi-card host runs).  (a) Phase 1's FRAME loop (its
   configuration, words and bursts) on engines of 1, 2 and 4 shards, in
   turns (1, 2, 4, 4, 2, 1), counters zeroed just before each loop and
   read just after, each
   kernel's launches credited to the shard whose SAE it reads or writes.
   Checks: every step's products == phase 1's unsharded products,
   bitwise; incremental == dense read at every deadline; the events
   ingested equal; every kernel launched on every shard.  Prints each
   loop's events/s and ``serve_step`` p50/p99 beside phase 1's, the
   host time of ``route``, the host time of a steady step by part
   (``HostSpans``: chunking, ``route``, uploads and scatter, the
   dirty-tile refresh, its ``nonzero`` sync, the other reads, the gather
   onto shard 0) and, for the first loop of each count, two more steps
   under ``torch.profiler``.  (b) Phase 7's fleet feeds on a 2-shard engine
   (21 slots pad to 22) under the same ``StreamConfig`` (``shard_budget
   = 320``, ``shard_barrier_every = 4``).  Checks: the digests replay
   bitwise through the oracle on a 2-shard factory; a migration crosses
   shards; barrier steps fall every 4th deadline; each tier conserves
   its events; every kernel launched on both shards.  Prints the three
   steps of longest readout latency with the actions logged around
   them.  (c) One migration
   from shard 0 to shard 3 of a 4-shard QVGA pool of 8 slots: every leaf
   bitwise the unsharded engine's after the same move, and the next
   ``serve_step`` too; device and host ms of the move beside the same
   move in one unsharded pool.  (d) ``python -m repro_torch.launch.serve
   sensors --mesh 2 --hw 48x64 --duration 0.05 --sensors 4`` in a
   subprocess: the placement printed and the fused surface bitwise the
   dense read.
9. **Cards** -- only where more than one card is visible (one card:
   skipped with a line).  One small copy between every ordered pair of
   cards, one untimed loop on one shard per card, then phase 8 (a)'s
   loop with N shards on card 0, N shards on the N cards and 2 shards on
   2 cards, in turns, each checked as in phase 8 (a); one migration
   from card 0's shard to the last card's, checked as in phase 8 (c);
   phase 8 (b)'s fleet on one shard per card, twice (the second on
   cards the first warmed), checked as there.
10. **Vision training** -- under PyTorch's default cuDNN TF32 (on), so
   the port's own float32 rule for every forward and backward is what is
   checked; every time host clock ending in ``torch.cuda.synchronize()``.
   (a) The example's protocol (``repro_torch.train.recon``, which
   ``examples/reconstruct_video_torch.py`` runs) at 48x48
   (``davis_like(3, 48, 48, 0.4, seed=9)``, 30 pairs, UNet width 12,
   AdamW, batch 16, 80 steps) on the card and on the CPU port at
   ``RECON_CPU_THREADS`` threads (the count moves a CPU run's rounding).
   Checks: every backward ran with TF32 off in cuDNN and cuBLAS and
   cuDNN off (``recon.make_step``'s direct convolutions, which keep the
   reference's exact zeros), the flags restored after; step 1's loss
   within 1e-5 and gradients within rtol 1e-4, atol 1e-4 x max|CPU leaf|
   of the CPU's, every gradient cell that is exactly 0 on the CPU 0 on
   the card; every loss finite;
   the held-out SSIM card vs CPU within 0.02, each device's the median of
   9 runs (the example's, then 8 from ``recon.jitter``'s weights: a run
   parts from any 1e-7 perturbation within ~6 steps and ends near 0.340
   in most runs, near 0.323 or lower in the rest).  Prints the SSIMs and
   the step-1 gradient error at PyTorch's defaults (TF32 in the
   backward).
   (b) The same protocol at DAVIS240C's 180x240: ``davis_like(8, 180,
   240, 1.0, seed=9)``, 200 pairs (150 train, 50 held out), 300 steps
   after 5 warm-up steps.  Prints ms per step p50/p99, pairs/s, peak
   allocated memory, the held-out SSIM, and two steps under
   ``torch.profiler`` (the device's idle share, the top device ops).
   Checks: every loss finite; the mean L1 of the last 10 steps below the
   first 10's; the SSIM finite.  (c) The classification protocol's step:
   ``cnn_defs(1, 6, width=16)`` (``PRNGKey(7)``) on ``streaming_ts``
   eDRAM frames of ``nmnist_like(6, 6, 48, 48, 0.25, seed=5)`` (50 ms
   windows of 4096 events, per-cell planes from ``PRNGKey(0)``, the last
   stream of every three held out), 20 AdamW steps at batch 32 on the
   card (on cuDNN, which keeps this CNN's exact zeros) and on the CPU
   port.  Checks: step 1's gradients in the band of (a), exact zeros
   kept; every loss finite.  Prints ms per step and two card steps under
   ``torch.profiler``.  (d) ``ts_decay``'s (H, W)
   planes form on (b)'s 200 SAEs with their (1, 180, 240) planes,
   through ``surface_read_kernel``: within 2 ULP of ``ts_edram``.
11. **LM training** -- every time host clock ending in
   ``torch.cuda.synchronize()``.  (a) The port's ``Trainer`` on
   mamba2-2.7b at full width and depth (2.83 B float32 master weights
   from ``PRNGKey(0)``, bf16 activations, remat on, 8 strided
   microbatches, AdamW updated in place) on ``TokenPipeline(50280,
   batch=8, seq=2048, seed=0)``: 1 warm-up step, then 3 timed steps with
   the counters zeroed just before and read just after, then one step
   under ``torch.profiler`` (the device's activity only).  Prints ms per
   step, tokens/s, peak allocated memory, launches a step, the device's
   idle share, the top device kernels and ``decay_scan``'s forward and
   backward share.  Checks: every loss finite, step 0's within 1.0 of
   ln 50432; ``decay_scan`` launched 2 x 64 x 8 times a step (the
   forward and its remat recompute) and ``decay_scan_bwd`` 64 x 8; peak
   allocated under the card's memory and 80 GB.  (b) The same model at
   2 layers in float32, one step's gradients (batch 2 x 300, 2
   microbatches) on the card against the CPU port: loss within 1e-5
   relative, gradients within rtol 1e-4, atol 1e-4 x max|CPU leaf|,
   every cell 0 in two CPU runs (at the default thread count and at 1
   thread, whose sums run in another order) 0 on the card.
   (c) The reduced config on the card: 30 steps, the mean loss of the
   last 5 below the first 5's; 4 straight steps == 2 steps, ``save``, a
   new ``Trainer``'s ``maybe_restore`` and 2 steps, bitwise; 3 finite
   steps each with int8 and top-k gradient compression; ``python -m
   repro_torch.launch.train --arch mamba2-2.7b --reduced --steps 3`` in
   a subprocess.
12. **Dense LM family** -- every time host clock ending in
   ``torch.cuda.synchronize()``; TF32 off.  (a) ``qwen3-8b`` uncut (36
   layers, d_model 4096, 32 query and 8 KV heads of 128, d_ff 12288,
   vocab 151,936 padded to 152,064; 8.19 B float32 parameters from
   ``PRNGKey(0)``, bf16 activations and KV cache) served through
   ``ServeEngine`` on the LM phase's traffic (8 requests of 1024-2048
   prompt tokens, left-padded, 32 greedy tokens each) after a warm-up
   serve.  Prints prefill tokens/s, decode ms per step p50/p99, peak
   allocated memory, and a prefill and two decode steps under
   ``torch.profiler`` (device ms by op, launches, the device's idle
   share).  Checks: the widths, the parameter count, every logit finite,
   every token inside the true vocab, and none of the port's CUDA
   kernels launched (this path runs on PyTorch ops).  (b) The same for
   ``gemma3-4b`` uncut (34 layers, 5:1 local (window 1024):global, 8
   query and 4 KV heads of 256, vocab 262,144, final softcap 30): the
   prompts are longer than the window, so the local rings wrap in
   prefill and again in decode.  (c) The card against the CPU
   port on ``PRNGKey(1)`` weights (the attention projections scaled to
   their true fan-in: ``dense_check`` says why) in float32 at full
   widths, batch 2: ``qwen3-8b``, ``glm4-9b`` and ``gemma2-27b`` at 2
   layers, ``gemma3-4b`` at 6; a prefill of 300 tokens (last logits and
   caches), then 8 decode steps (logits, caches); ``qwen3-8b`` with an
   int8 KV cache decoding 8 steps from empty caches (the reference's
   prefill builds unquantized ones); band rtol 1e-4, atol 1e-4 x max(1,
   max|CPU|), positions bitwise; int8 codes within 1 on at most 1 in
   1000 of a step's new cells, bf16 scales within one bf16 ulp, and the
   batch rows whose codes differ in a step held to 3e-3 in that step
   (``DENSE_INT8_TOL`` says why), the card's codes carried over to the
   CPU after each step.  Then
   one training step's gradients of ``qwen3-8b`` at 2 layers in float32 (``fsdp=True`` from
   its config, no mesh; batch 2 x 300, 2 microbatches) against the CPU
   port in phase 11 (b)'s band, with its exact-zero rule.  (d) The
   event-LM example's protocol (``repro_torch.train.event_lm``: 30 AdamW
   steps) on the card and on the CPU port: the loss curve, the held-out
   accuracies, ms per step; checks every loss finite and step 0's within
   1e-5 relative of the CPU's.  Then step 0's batch once more at the
   example's weights with the attention projections at their true
   fan-in (at the example's own, the reference's gradients move by more
   than the band when the weights move by half an ulp): loss and
   gradients, through the decoder, the embeds and the event frontend,
   card against the CPU port in phase 11 (b)'s band with its exact-zero
   rule.
13. **Hybrid and MoE LM families** -- TF32 off; every time host clock
   ending in ``torch.cuda.synchronize()``.  (a) ``hymba-1.5b`` uncut (32
   layers, each GQA attention of 25 query and 5 KV heads of 64 beside a
   Mamba-2 head of 25 SSD heads x 64, state 16, the two normalised and
   averaged; layers 0, 15 and 31 global, the others a window of 1024;
   d_model 1600, d_ff 5504, vocab 32,001 padded to 32,256; 1.394 B
   float32 parameters from ``PRNGKey(0)``, bf16 activations) served
   through ``ServeEngine`` on the LM phase's traffic after a warm-up
   serve, as phase 12 (a) serves (``serve_lm``): prefill tokens/s, decode
   p50/p99, peak allocated, a profiled prefill (``decay_scan``'s share)
   and two decode steps (launches a step).  Checks: the widths and the
   parameter count, ``decay_scan`` launched 32 times by the prefill and
   never by a decode step, logits finite, tokens inside the vocab.
   (b) ``grok-1-314b`` at its full widths and 2 of its 64 layers (d_model
   6144, 48 query and 8 KV heads of 128, 8 experts top-2 of d_ff 32,768,
   vocab 131,072; 11.45 B float32 parameters, each expert's weights cast
   to bf16 one expert at a time in ``moe_dense``) served the same way;
   then the tokens each expert took in one more prefill and ``lb_loss``
   / ``z_loss`` of one ``forward`` of 2 x 512 tokens.  Checks: the
   widths, the parameter count, the peak inside the card, none of the
   port's kernels launched, the aux losses finite.  (c) The card against
   the CPU port in float32 on ``PRNGKey(1)`` weights with the attention
   projections at their true fan-in, each through ``dense_check``
   (``forward``, a prefill and 8 decode steps: logits, K/V rings, conv
   rings and SSM states): ``hymba-1.5b`` at full widths and 2 layers
   (one global, one local), batch 2 x 1100 (the window wraps);
   ``grok-1-314b`` at full widths and 1 layer, batch 1 x 256 (26 GB of
   float32 weights on each device); ``kimi-k2-1t-a32b`` at ``reduced()``
   (its one layer is 16.9 B parameters), batch 2 x 300.  Expert choices
   equal in every layer (a batch row where a token's choice differs, a
   near tie, is printed with its router-probability gap and left out of
   the logits and caches from that call on; more than 1 in 1000 of the
   routed tokens fails), logits in phase 12 (c)'s band, ``forward``'s
   ``lb_loss`` and ``z_loss`` within 1e-4 relative; one gradient step (``loss_fn``'s
   total with its aux terms; batch 2 x 300 in 2 microbatches) of hymba
   at 2 layers and kimi at ``reduced()`` in phase 11 (b)'s band.
   (d) ``decay_scan`` at hymba's prefill shape (8, 15, 25,600) as phase 4
   runs it: bitwise against its plain version, timed beside its bound.
14. **Paper-facing leftovers** -- (a) ``examples/quickstart_torch.py``,
   ``denoise_stream_torch.py`` and ``serve_sensors_torch.py`` through
   their ``main`` on the card, then with ``--device cpu`` in the same
   process, then ``serve_sensors`` with ``--mesh 2`` on the card (the
   launches of the three card runs are the examples' path).  Checks:
   quickstart supports bitwise, AUCs within 1e-6 (``roc_curve`` sums in
   another order on the card), the analog surface within 4 ULP
   (``QVGA_ULP``: CUDA's ``expf`` is within 2 ULP, the CPU's ``exp``
   within 1); denoise window masks (3d, 2d) and support bitwise, AUC
   within 1e-6;
   serve_sensors' own asserts (fused logits bitwise ``cnn_apply``,
   per-tier conservation, both oracle gates) on the card, occupancy,
   active pixels, event counts and replay counters equal to the CPU
   port's, logits within rtol 1e-5; the 2-shard run's counters and
   products equal to the unsharded run's.  (b) ``get_config("isc-qvga")``
   (240x320, 1 polarity, 20 fF, 24 ms, r = 3, threshold 2) as a
   ``TSEngineConfig`` of 4 slots: serve_sensors' mix (driving x 2,
   hotel_bar x 2, 0.2 s each, ~1.6 M events) in 10 windows of two bursts
   through ``serve_step`` with the FRAME spec (timed: p50/p99); the same
   bursts through the deprecated shims (``acquire``, ``ingest``,
   ``ingest_and_read``, ``readout_with_mask``, ``support_map``,
   ``readout``, ``ingest(with_support=True)``, ``release``) on one engine
   and the session/spec path on a twin, window by window; a CPU engine's
   FRAME loop on the same events; the quickstart pipeline
   (``ISCArray(240, 320)``, ``stcf_chunked`` analog and ideal) on the
   whole 0.2 s ``hotel_bar`` stream on the card and the CPU port; and
   ``ref.ts_fused_ref`` against the ``chunk_scatter`` and ``ts_decay``
   kernels on one 10 ms push.  Checks: every shim output bitwise its
   twin's, equal launches a window, each kernel launched under the
   shims; SAE, counts, masks and supports bitwise the CPU port's,
   surfaces within 4 ULP; the quickstart's supports bitwise and AUCs
   within 1e-6 (their gap printed); ``ts_fused_ref``'s SAE, surface and mask
   bitwise the kernels'.
15. **The LM trainer over a mesh** -- the ranks run in child processes
   (``torch.multiprocessing.spawn``, one NCCL rank a card, after
   ``torch.cuda.empty_cache()``); a rank that raises fails the run.  TF32
   off; every time host clock ending in a synchronize and a barrier on
   every rank.  (a) A ``(1, 1)`` mesh of one rank on card 0:
   ``qwen3-8b`` at full widths and 2 layers, batch 8 x 2048 in 8
   microbatches, 2 steps through ``Trainer(mesh=...)`` against the
   one-card ``Trainer``: losses and every parameter bitwise (every
   collective over one rank is the identity).  ``moe_sharded`` (``ep``
   at model = 1) at ``grok-1-314b``'s full widths (8 experts of d_ff
   32,768, float32 weights drawn on the card) on 256 tokens against the
   CPU port's on the same inputs: rtol 1e-4, atol 1e-4 x max(1,
   max|CPU|), no routing flipped, the aux losses within 1e-4 relative.
   (b) Only where N = min(4, cards) >= 2 (one card: skipped with a
   line).  1. ``qwen3-8b`` uncut (8.19 B parameters, FSDP over (N, 1),
   8 microbatches, remat, AdamW at lr 3e-4 with one warm-up step), batch
   32 x 2048: 1 warm-up and 3 timed steps; ms a step, tokens/s, each
   card's peak allocated memory, and one more step under
   ``torch.profiler`` on rank 0 (NCCL kernels against the rest).  Checks:
   every loss finite, step 3's below step 0's, every card's peak under 80
   GB.  2. ``mamba2-2.7b`` uncut over (N, 1), batch 8N x 2048 (each card
   phase 11 (a)'s work): tokens/s against phase 11 (a)'s one-card run,
   as a share of N x; checks ``decay_scan`` and ``decay_scan_bwd``
   launched 1,024 and 512 times a step on every rank.  3. ``qwen3-8b``
   at full widths and 2 layers with float32 activations, batch 32 x
   256, 3 steps at (1)'s lr over (N, 1), over (2, 2) (N = 4; else
   (1, N)) and over (N, 1) with ``fsdp_gather_once``, each against the
   one-card trainer on card 0: losses within 1e-5 relative (step 2's
   after a step at the whole lr) and AdamW's first moments (the clipped
   gradients) within rtol 1e-4, atol 1e-4 x max|leaf|; and over (N, 1)
   at batches 24 and 16 x 256 (3 and 2 rows a microbatch of 8 over N = 4
   ranks: each rank pads its block, as GSPMD pads the reference's), each
   against the one-card trainer at its batch in the same bands, with its
   ms a step beside the card's ``nvidia-smi`` name and power limit.  The
   parameters' distance is printed, not held: Adam's per-cell
   normalisation turns a rounding of a cell whose gradient sits near
   its sum's rounding into
   a sizeable share of a step.  Float32, because the band is a float32
   one: in bfloat16 the mesh sums its ranks' bfloat16-rounded partial
   gradients where one card rounds their sum.  4. The (N, 1)
   run's checkpoint (whole leaves, gathered to
   rank 0) restored onto (3)'s second mesh and onto one card: parameters
   and optimizer state bitwise; then one more step on each: the loss
   and the first moments in (3)'s bands.  5. ``pipeline_forward`` of N
   ``tanh(h @ w)`` stages (8 microbatches of (8, 4096)) over N cards:
   bitwise each microbatch run through the stages in turn on card 0.

16. **LM serving over a mesh** -- spawned as phase 15's ranks are.
   ``ServeEngine(mesh=)``: each rank holds its blocks of the parameters
   and of every cache (the batch over the data axes that divide it, the
   K/V rings' sequence over ``cache_seq_axes``: flash-decoding), serves
   its rows, and gathers the last logits over ``"model"`` before the
   greedy ``argmax``.  (a) A (1, 1) mesh of one rank on card 0:
   ``qwen3-8b`` and ``hymba-1.5b`` at full widths and 2 layers (bf16)
   on 8 requests of 256-512 prompt tokens, 32 greedy tokens, against the
   one-card ``ServeEngine`` on the same weights: tokens, every call's
   logits and the caches bitwise; ``decay_scan`` launched once a hymba
   layer by the prefill, never by a decode step, and held bitwise
   against its plain version on the inputs of the rank's own prefill
   (kept from the served path, so at the shape it runs there; these
   launches come after the path's counts are read).  (b) Only where N =
   min(4, cards) >= 2.  1. ``gemma2-27b`` uncut (28.41 B float32
   parameters, which no one card holds; each rank draws its blocks from
   ``PRNGKey(0)``) over (1, N), so that its caches of 2,080 slots split N
   ways, on the LM phase's traffic (8 requests of 1024-2048 prompt
   tokens, 32 greedy tokens): prefill tokens/s, decode ms a step p50 and
   p99, each card's peak, and one warm-up decode step under
   ``torch.profiler`` on rank 0 (NCCL kernels against the rest).  Checks:
   every logit finite and every token in the vocab on every rank, every
   card's peak under 80 GB, none of the port's kernels launched.  2.
   ``hymba-1.5b`` uncut over (2, 2) (N = 4; else (N, 1)) on the same
   traffic: prefill tokens/s, decode p50; ``decay_scan`` launched 32
   times by the prefill on every rank, and held bitwise against its
   plain version on each rank's own prefill inputs (4 rows over (2, 2));
   its tokens' agreement with the
   one-card engine on card 0 printed, not held (bf16 sums in another
   order).  3. ``gemma2-27b`` and ``hymba-1.5b`` at full widths, 2
   layers, float32 activations (the attention projections at their true
   fan-in, as phase 12 (c)), 4 requests of 192-320 prompt tokens, 8
   tokens, and hymba again on 4 prompts of 1,100-1,300 tokens (past its
   window of 1,024: the local ring is rolled, and splits over (1, N) and
   (2, 2)), over (1, N), (2, 2) (N = 4) and (N, 1), each against the
   one-card engine on card 0: the prefill's last logits and every decode
   step's within rtol 1e-4, atol 1e-4 x max(1, max|one card|); greedy
   tokens equal (a step whose one-card top-2 gap lies inside that band
   leaves its row out from then on, and is counted); the caches gathered
   back in the band, positions bitwise.

17. **Capacity and roofline** -- no new model: for each configuration an
   earlier phase of the same call measured (mamba2-2.7b trained on one
   card, 11 (a); qwen3-8b served on one card, 12 (a); where N >= 2,
   qwen3-8b trained over (N, 1), 15 (b) 1, and gemma2-27b served over
   (1, N), 16 (b) 1), ``launch.dryrun.static_capacity_model`` for its
   config and mesh shape at the phase's own traffic, and
   ``launch.roofline``'s ``model_flops`` and ``roofline_terms`` (the
   H100's bf16 peak and HBM rate; the persistent bytes read once; no
   collective term) against the measured step or prefill time.  Checks:
   the persistent state (params + opt_state + grad_accum + kv_cache) no
   more than the measured peak; no roofline share (the bound's or the
   useful FLOPs') over 100 %.

``--mesh PART[,PART...]`` runs only those parts of phases 15 and 16
over N cards (``one`` for 15 (a); ``full``, ``mamba``, ``check`` for
(b) 3 and 4, ``pp``; ``serve-one`` for 16 (a); ``serve-full``,
``serve-hybrid``, ``serve-check`` for 16 (b) 1-3, ``serve-cards`` for
all three), then phase 17's cases of ``full`` and ``serve-full`` where
they ran, and exits 0 when every check passed, without the last line:
the quick rerun of one part on a host of several cards.

Output: progress lines, one JSON line of the kernels, the card's
``nvidia-smi`` name and power limit, and last the line
``{"ok": true, "device": {...}}``.  Any failed check, build error or
launch error exits nonzero without that line.  Without a CUDA device, or
without the repository's sources beside it, it exits 2.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import importlib
import io
import json
import os
import runpy
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores

S, P, H, W = 64, 2, 240, 320
CAP = 2048
N_SCENES = 8
DEADLINES = 10
DEADLINE_S = 0.010
RADIUS = 3
ENGINE_KERNELS = ("ts_decay", "stcf_support", "chunk_scatter")

LM_ARCH = "mamba2-2.7b"
LM_REQUESTS = 8
LM_PROMPT = (1024, 2048)      # prompt lengths drawn in [lo, hi]
LM_NEW_TOKENS = 32
CHECK_LAYERS = 2              # depth of the float32 card-vs-CPU model
CHECK_BATCH, CHECK_PROMPT = 2, 300
TRAIN_BATCH, TRAIN_SEQ = 8, 2048   # phase 11 (a): 8 microbatches of 1 row
TRAIN_TIMED_STEPS = 3
TRAIN_CHECK = (2, 2, 300)     # phase 11 (b): layers, batch, seq (2 microbatches)
TRAIN_REDUCED_STEPS = 30      # phase 11 (c)
TRAIN_REDUCED_BATCH = (8, 64)
TRAIN_CLI_ARGV = ("--arch", "mamba2-2.7b", "--reduced", "--steps", "3")
LM_TOL = 1e-4    # rtol; atol x max(1, max|ref|): float32 card vs CPU, recurrent
DENSE_ARCH = "qwen3-8b"
DENSE_SERVE = ("qwen3-8b", "gemma3-4b")   # phase 12 (a), (b), uncut
#: d_model, heads, KV heads, head_dim, d_ff, vocab, padded vocab, window,
#: final softcap: the published widths phase 12 (a), (b) serve at
DENSE_WIDTHS = {
    "qwen3-8b": (4096, 32, 8, 128, 12288, 151936, 152064, 4096, None),
    "gemma3-4b": (2560, 8, 4, 256, 10240, 262144, 262144, 1024, 30.0),
}
DENSE_CHECK = (("qwen3-8b", 2), ("glm4-9b", 2), ("gemma2-27b", 2),
               ("gemma3-4b", 6))   # phase 12 (c): arch, layers
DENSE_CHECK_DECODE = 8
DENSE_TOL = 1e-4  # rtol; atol x max(1, max|CPU|): float32 card vs CPU port
#: the band of a batch row's logits in an int8 decode step whose new codes
#: differ between the devices in that row: a code one apart moves its K/V
#: cell by a quantization step, 1/127 (0.8 %) of its row's max, which
#: float32 rounding alone does not (measured on an H100: one such cell
#: moved its row's logits 9.8e-4, 40x the float steps' largest error);
#: the other rows keep DENSE_TOL
DENSE_INT8_TOL = 3e-3
EVENT_LM_STEPS = 30
HYBRID_ARCH = "hymba-1.5b"      # phase 13 (a), uncut
#: d_model, query / KV heads, head_dim, d_ff, vocab, padded vocab, window,
#: global layers, SSM (d_inner, heads, headdim, state): the published
#: widths phase 13 (a) serves at
HYBRID_WIDTHS = (1600, 25, 5, 64, 5504, 32001, 32256, 1024, (0, 15, 31),
                 (1600, 25, 64, 16))
MOE_ARCH = "grok-1-314b"        # phase 13 (b), full widths
MOE_LAYERS = 2                  # of 64: 11.45 B float32 parameters
#: d_model, query / KV heads, head_dim, experts, top-k, d_ff_expert,
#: vocab, padded vocab
MOE_WIDTHS = (6144, 48, 8, 128, 8, 2, 32768, 131072, 131072)
MOE_AUX_SEQ = (2, 512)          # (b): the batch of the forward whose aux is printed
HYBRID_CHECK = (2, 1100)        # (c): hymba layers, prompt (past the window)
MOE_CHECK = (1, 1, 256)         # (c): grok layers, batch, tokens
#: the share of routed tokens whose expert choices may differ between the
#: card and the CPU port: a token whose k-th and (k+1)-th router
#: probabilities lie within float32 rounding of each other may route
#: either way on two devices that sum in other orders; more than this
#: many is a fault, not rounding
ROUTE_FLIPS = 1e-3

HEADS_KEY = "chip-smoke-heads"
HEADS_CLASSES, HEADS_WIDTH = 10, 32
HEADS_CHECK_SLOTS = 4
HEADS_TOL = 1e-4  # rtol; atol x max(1, max|CPU|): float32 card vs CPU CNN
LABEL_SENSORS = 8

SWEEP_CLASSES = 4                 # the sweep CLI's default --classes
ANALOG_CHECK_SLOTS = 8
ANALOG_ULP = 8    # card vs CPU port analog reads (the CPU tests' analog_2d band)
STREAM_DEADLINES = DEADLINES
STREAM_SUBSTEPS = 2
SWEEP_ARGV = ("--hw", "120x160", "--sensors", "4", "--duration", "0.06",
              "--cmem", "10,20", "--retention", "12,24")
SWEEP_TIMEOUT_S = 400

FLEET_SENSORS = 64
FLEET_BUCKET = max(2, FLEET_SENSORS // 3)   # the --migrate-demo rule: 21
FLEET_MOVES = 4
FLEET_SHARD_BUDGET = 320
FLEET_BARRIER_EVERY = 4
FLEET_SMALL_HW = (60, 80)                   # card vs CPU engine
FLEET_CLI_ARGV = ("--migrate-demo", "--hw", "48x64", "--duration", "0.06",
                  "--deadline", "0.005")

SHARD_COUNTS = (1, 2, 4)      # shards of phase 8's FRAME loop, one card
SHARD_LOOP_CHECKED = 2        # the loop whose launches the JSON line reports
SHARD_MIGRATE_SHARDS, SHARD_MIGRATE_SLOTS = 4, 8
SHARD_CLI_ARGV = ("sensors", "--mesh", "2", "--hw", "48x64",
                  "--duration", "0.05", "--sensors", "4")

RECON_SSIM_TOL = 0.02         # card vs CPU held-out SSIM after 80 steps
RECON_MEMBERS = 9             # runs a device's median SSIM is taken over
RECON_CPU_THREADS = 4         # the CPU runs' thread count (it moves the SSIM)
GRAD_TOL = 1e-4   # the CPU tests' band: loss 1e-5 rel.; grads 1e-4 x max|CPU leaf|
DAVIS_HW = (180, 240)         # DAVIS240C's sensor
DAVIS_SCENES = 8
DAVIS_DURATION = 1.0          # 25 frames a scene at 25 fps
DAVIS_STEPS = 300
DAVIS_WARMUP = 5
BATCH = 16
CLS_CLASSES = 6
CLS_HW = 48
CLS_WINDOW_S = 0.05
CLS_STEPS = 20
CLS_BATCH = 32

EXAMPLE_FILES = ("quickstart_torch.py", "denoise_stream_torch.py",
                 "serve_sensors_torch.py")      # phase 14 (a)
ISC_ARCH = "isc-qvga"                           # phase 14 (b)
QVGA_SCENES = ("driving", "driving", "hotel_bar", "hotel_bar")  # serve_sensors'
QVGA_DURATION = 0.2
QVGA_WINDOW_S = 0.02          # 10 windows of two bursts
QVGA_CHUNK = 4096             # serve_sensors' chunk capacity
QVGA_LABEL_SEED = 99          # the labeled push: serve_sensors' swapped camera
#: card vs CPU port decay reads, in ULP: CUDA's expf is within 2 ULP of
#: the rounded exp, the CPU's within 1, so each exp of the double exp may
#: sit 3 apart, and the sum rounds once more (3 measured on an H100)
QVGA_ULP = 4
#: AUCs card vs CPU port from bitwise supports: roc_curve's float32 sums
#: run in another order on the card (6e-8 apart measured on an H100)
AUC_TOL = 1e-6
QVGA_FUSED_SEED = 7           # the one 10 ms push ts_fused_ref is held on

REPLACES = {
    "ts_decay": "src/repro/kernels/ts_decay.py:107",
    "stcf_support": "src/repro/kernels/stcf.py:86",
    "chunk_scatter": "src/repro/kernels/ts_fused.py:81",
    "decay_scan": "src/repro/kernels/decay_scan.py:83",
}
SOURCES = {
    "ts_decay": "src/repro_torch/kernels/csrc/ts_decay.cu",
    "stcf_support": "src/repro_torch/kernels/csrc/stcf.cu",
    "chunk_scatter": "src/repro_torch/kernels/csrc/ts_fused.cu",
    "decay_scan": "src/repro_torch/kernels/csrc/decay_scan.cu",
}

FAILURES: list = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    log(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        FAILURES.append(what)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(bits(a).cpu(), bits(b).cpu())


class Timer:
    """Median kernel time in ms from CUDA events around single launches,
    with the 50 MB L2 flushed (and any per-launch state reset) outside the
    timed region before each one."""

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int, setup=None, flush=True) -> float:
        for _ in range(2):
            fn(setup() if setup else None)
        times = []
        for _ in range(reps):
            arg = setup() if setup else None
            if flush:
                self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(arg)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def in_turns(timer, new, old, reps: int, what: str, **kw):
    """Time ``new`` alone, or ``old`` and ``new`` in turns (old, new, new,
    old) when there is an ``old``.  Returns (new ms, old ms or None), each
    the mean of its turns' medians."""
    if old is None:
        return timer(new, reps, **kw), None
    turns = [timer(fn, reps, **kw) for fn in (old, new, new, old)]
    log(f"  {what} in turns old, new, new, old: "
        f"{[round(t, 4) for t in turns]} ms")
    return (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2


def build_prev(prev_root: Path):
    """The ``ts_decay``, ``stcf_support`` and ``chunk_scatter`` kernels of
    another checkout (``--prev``, e.g. the parent commit's tree; its
    ``ts_decay.cu`` with the first version's plane entry), compiled with
    this tree's flags into a library of their own, each source with the
    headers beside it.  Returns a function that calls one of their C
    entry points on the current stream."""
    from repro_torch.kernels import _lib

    csrc = prev_root / "src" / "repro_torch" / "kernels" / "csrc"
    out = ROOT / "build" / "prev_kernels"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    nvcc = _lib._nvcc()
    objs, procs = [], []
    for src in ("ts_decay.cu", "stcf.cu", "ts_fused.cu"):
        objs.append(str(out / (src + ".o")))
        procs.append(subprocess.Popen(
            [nvcc, *_lib.NVCC_FLAGS, "-c", str(csrc / src), "-o", objs[-1]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {prev_root}:\n{text}")
    lib_path = out / "libprev_kernels.so"
    subprocess.run([nvcc, "-shared", "-Xcompiler", "-fPIC", *objs, "-o",
                    str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("ts_decay_uniform", "stcf_support_mask",
                 "stcf_support_fused", "chunk_scatter"):
        getattr(lib, name).argtypes = _lib._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    # the first version's plane entry: (n, plane), no launch shape
    lib.ts_decay_planes.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_float]
        + [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p])
    lib.ts_decay_planes.restype = ctypes.c_int
    log(f"build: the previous ts_decay, stcf_support and chunk_scatter from "
        f"{csrc} -> {lib_path}")

    def call(name, *args):
        err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"previous {name}: CUDA error {err}")
    return call


def prev_decay(call, sae, t_now, params, v_tw=None):
    """The previous ``ts_decay`` on ``sae``: ``v``, or ``(v, mask)``."""
    out = torch.empty_like(sae)
    mask = (None if v_tw is None else
            torch.empty(sae.shape, dtype=torch.bool, device=sae.device))
    mptr = None if mask is None else mask.data_ptr()
    thr = 0.0 if v_tw is None else float(v_tw)
    if params.varied:
        call("ts_decay_planes", sae.data_ptr(), out.data_ptr(), mptr,
             sae.numel(), params.tau1.numel(), float(t_now),
             *(x.data_ptr() for x in params), thr)
    else:
        call("ts_decay_uniform", sae.data_ptr(), out.data_ptr(), mptr,
             sae.numel(), float(t_now), *(float(x) for x in params), thr)
    return out if mask is None else (out, mask)


def prev_stcf(call, x, fused=None):
    """The previous ``stcf_support`` on (..., H, W) ``x`` at RADIUS."""
    h, w = x.shape[-2:]
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if fused is None:
        call("stcf_support_mask", x.data_ptr(), out.data_ptr(),
             x.numel() // (h * w), h, w, RADIUS, 0)
    else:
        params, v_tw, t_now = fused
        call("stcf_support_fused", x.data_ptr(), out.data_ptr(),
             x.numel() // (h * w), h, w, RADIUS, 0, float(t_now),
             *(float(v) for v in params), float(v_tw))
    return out


def prev_scatter(call, st, sids, ev, block):
    """The previous ``chunk_scatter`` into pool state ``st`` (sae, dirty,
    counts, t_last, n_events; any but sae may be None)."""
    s, p, h, w = st[0].shape
    b, n = ev.x.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    call("chunk_scatter", st[0].data_ptr(), s, p, h, w, sids.data_ptr(),
         ev.x.data_ptr(), ev.y.data_ptr(), ev.p.data_ptr(), ev.t.data_ptr(),
         ev.valid.data_ptr(), b, n, ptr(st[1]), block[0], block[1],
         ptr(st[2]), ptr(st[3]), ptr(st[4]))


def scatter_traffic(sids, ev, shape, block, segment):
    """What the sorted ``chunk_scatter`` issues for this push: the valid
    events, and the distinct (segment, key), (segment, cell) and
    (segment, tile) pairs -- one SAE atomic, one counter atomic and one
    dirty-mark store each (the per-event kernel issues two atomics and a
    store per valid event)."""
    s, p, h, w = shape
    b, n = ev.x.shape
    pol = torch.zeros_like(ev.p) if p == 1 else ev.p
    sid = sids.long()[:, None].expand(b, n)
    ok = (ev.valid & (ev.x >= 0) & (ev.x < w) & (ev.y >= 0) & (ev.y < h)
          & (pol >= 0) & (pol < p) & (sid >= 0) & (sid < s))
    j = torch.arange(n, device=ev.x.device)
    seg = (torch.arange(b, device=ev.x.device)[:, None] * -(-n // segment)
           + j // segment)[ok]
    x, y, pol = ev.x.long()[ok], ev.y.long()[ok], pol.long()[ok]
    cell = y * w + x
    th, tw = -(-h // block[0]), -(-w // block[1])
    tile = (pol * th + y // block[0]) * tw + x // block[1]
    n_ok = int(ok.sum())
    out = dict(events=n_ok)
    for name, v, span in (("sae_atomics", cell * p + pol, h * w * p),
                          ("count_atomics", cell, h * w),
                          ("dirty_stores", tile, p * th * tw)):
        out[name] = torch.unique(seg * span + v).numel()
    out["per_event"] = (out["sae_atomics"] + out["count_atomics"]) / max(n_ok, 1)
    return out


def duplicate_heavy_push(dev, s, p):
    """A seeded push at the engine's plane size: 8 rows of 5,000 event
    slots (more than one segment each), 90 % of the events on 8 hot
    cells, t on a 10 us grid (equal stamps inside a run), three rows
    aimed at slot 3, rows aimed at slots -1 and ``s`` (outside the pool),
    and x, y, p out of range on a few events."""
    from repro_torch.core import time_surface as ts

    g = torch.Generator(device=dev).manual_seed(5)
    b, n = 8, 5000

    def ints(lo, hi):
        return torch.randint(lo, hi, (b, n), generator=g, device=dev,
                             dtype=torch.int32)

    hot = torch.randint(0, 8, (b, n), generator=g, device=dev)
    hx = torch.randint(0, W, (8,), generator=g, device=dev, dtype=torch.int32)
    hy = torch.randint(0, H, (8,), generator=g, device=dev, dtype=torch.int32)
    is_hot = torch.rand((b, n), generator=g, device=dev) < 0.9
    pol = torch.where(torch.rand((b, n), generator=g, device=dev) < 0.01,
                      ints(0, 2) * 3 - 1, ints(0, p))   # -1 or 2 on 1 %
    ev = ts.EventBatch(
        x=torch.where(is_hot, hx[hot], ints(-2, W + 2)),
        y=torch.where(is_hot, hy[hot], ints(-2, H + 2)),
        t=0.1 + ints(0, 1000).float() * 1e-5,
        p=pol,
        valid=torch.rand((b, n), generator=g, device=dev) < 0.95)
    sids = torch.tensor([3, 3, 3, 7, s, 0, -1, s - 1], dtype=torch.int32,
                        device=dev)
    return sids, ev


def bound_ms(nbytes: float, nops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def make_scenes(datasets, aer):
    """Packed AER words per scene and half-deadline burst."""
    kinds = ("driving", "hotel_bar")
    duration = DEADLINES * DEADLINE_S
    half = DEADLINE_S / 2
    words = []
    for k in range(N_SCENES):
        s = datasets.dnd21_like(kinds[k % 2], H, W, duration, seed=k)
        words.append([aer.pack(s.window(b * half, (b + 1) * half))
                      for b in range(2 * DEADLINES)])
    return words


def run_engine(dev, mods, words, card):
    """Phase 1: the serving loop.  Returns what the kernel phase needs."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    base = dict(h=H, w=W, polarities=P, n_slots=S, chunk_capacity=CAP,
                mode="edram", specs=(frame,))
    cfg = eng.TSEngineConfig(**base)
    # a gather cap of the whole pool keeps every second burst on the
    # incremental path, whatever share of tiles the burst dirties
    cfg = dataclasses.replace(cfg, max_dirty_tiles=S * cfg.tile_counts()[2])
    engine = eng.TimeSurfaceEngine(cfg)
    sessions = [engine.attach() for _ in range(S)]
    scene_of = [k % N_SCENES for k in range(S)]
    bursts = [[(sessions[k], words[scene_of[k]][b]) for k in range(S)]
              for b in range(2 * DEADLINES)]
    tiles_total = engine.state.cache.dirty.numel()

    torch.cuda.synchronize()
    _lib.reset_launches()
    step_ms, dirty_share, mismatched = [], [], []
    step_outs = []   # every step's products, for phase 8's shards
    t_wall = 0.0
    for d in range(DEADLINES):
        t_now = (d + 1) * DEADLINE_S
        for half in range(2):
            items = bursts[2 * d + half]
            t0 = time.perf_counter()
            out = engine.serve_step(items, frame, t_now)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            t_wall += dt
            step_ms.append(dt * 1e3)
            step_outs.append(out)
        path_counts = dict(_lib.LAUNCHES)   # the check read is not counted
        dense = engine.read(rs.SURFACE_SPEC, t_now)["surface"]
        _lib.LAUNCHES.update(path_counts)
        if not same(out["surface"], dense):
            mismatched.append(d)
    launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    n_events = int(engine.state.surfaces.n_events.sum())

    log(f"engine on {card}: {S} sensors x {P}x{H}x{W}, {DEADLINES} deadlines "
        f"x 2 bursts, {n_events} events ingested in {t_wall:.4f} s of "
        f"serve_step -> {n_events / t_wall:.1f} events/s")
    steady = step_ms[2:]   # the first deadline pays first-touch costs
    log(f"engine on {card}: serve_step (push + read) latency over deadlines "
        f"2..{DEADLINES}: "
        f"p50 {np.percentile(steady, 50):.3f} ms, "
        f"p99 {np.percentile(steady, 99):.3f} ms "
        f"(dense fill p50 {np.percentile(steady[0::2], 50):.3f} ms, "
        f"incremental p50 {np.percentile(steady[1::2], 50):.3f} ms); "
        f"first deadline {step_ms[0]:.3f} + {step_ms[1]:.3f} ms")
    log(f"engine: every serve_step, ms: {[round(x, 3) for x in step_ms]}")
    log(f"engine: kernel launches on the path: {launches}")
    for k, n in launches.items():
        check(n > 0, f"{k} launched on the engine path ({n})")

    check(not mismatched, f"incremental serve_step == dense read, bitwise, "
          f"at every deadline (mismatched: {mismatched})")
    t_end = DEADLINES * DEADLINE_S

    # independent offline build: unpack every word a scene sent, sae_update
    params = cfg.decay_params()
    offline = []
    for k in range(N_SCENES):
        stream = aer.unpack(np.concatenate(words[k]), H, W)
        batch = pipeline.to_event_batch(stream, device=dev)
        offline.append(ts.sae_update(ts.empty_sae(H, W, P, dev), batch))
    offline = torch.stack([offline[scene_of[k]] for k in range(S)])
    check(same(offline, engine.state.surfaces.sae),
          "engine SAE == offline sae_update SAE, bitwise")
    check(same(ops.ts_decay(offline, t_end, params), out["surface"]),
          "engine surface == ops.ts_decay(offline SAE), bitwise")

    # the CPU port on the same events
    cpu = eng.TimeSurfaceEngine(cfg, device="cpu")
    cpu_sessions = [cpu.attach() for _ in range(S)]
    for items in bursts:
        cpu.push([(cpu_sessions[k], w) for k, (_, w) in enumerate(items)])
        dirty_share.append(float(cpu.state.cache.dirty.float().mean()))
        cpu.state.cache.dirty.zero_()
    g, c = engine.state, cpu.state
    for name, a, b in (("sae", g.surfaces.sae, c.surfaces.sae),
                       ("t_last", g.surfaces.t_last, c.surfaces.t_last),
                       ("n_events", g.surfaces.n_events, c.surfaces.n_events),
                       ("counts", g.counts, c.counts)):
        check(same(a, b), f"card {name} == CPU port {name}, bitwise")
    log(f"engine: share of the pool's {tiles_total} dirty tiles written by "
        f"one 5 ms burst: mean {np.mean(dirty_share):.4f}")
    split_pass(eng, cfg, frame, words, scene_of)
    return dict(engine=engine, cfg=cfg, t_end=t_end, launches=launches,
                n_events=n_events, events_per_s=n_events / t_wall,
                step_ms=step_ms, step_outs=step_outs, frame=frame)


def split_pass(eng, cfg, frame, words, scene_of):
    """Where a serve_step's time goes: the same bursts into a fresh engine,
    each step run as its two halves -- ``push``, then the cached read
    ``serve_step`` does after its push -- with the host-only part of the
    push (cutting payloads into chunks, ``_collect``) timed on its own
    first.  Runs after the path's launch counts were read."""
    engine = eng.TimeSurfaceEngine(cfg)
    for _ in range(S):
        engine.attach()
    rows = []
    for b in range(2 * DEADLINES):
        items = [(k, words[scene_of[k]][b]) for k in range(S)]
        t_now = (b // 2 + 1) * DEADLINE_S
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._collect(items)
        t1 = time.perf_counter()
        engine.push(items)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        engine.serve_step([], frame, t_now)
        torch.cuda.synchronize()
        rows.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    r = np.array(rows[2:]) * 1e3
    med = np.median(r, axis=0)
    log(f"engine breakdown, every step (chunking, push, read) ms: "
        f"{[tuple(round(x * 1e3, 3) for x in row) for row in rows]}")
    log(f"engine breakdown, median ms over steps 3..{2 * DEADLINES}: host "
        f"chunking alone {med[0]:.3f}; push (chunking + copy + scatter) "
        f"{med[1]:.3f}; cached read {med[2]:.3f} (dense "
        f"{np.median(r[0::2, 2]):.3f}, incremental {np.median(r[1::2, 2]):.3f})")


def division_gate_phase(dev) -> dict:
    """decay.cuh's corrected-reciprocal quotient against ``__fdiv_rn`` on
    the card: every float32 dividend of each of ``gate_taus()``, then
    2^32 random (dividend, tau1, tau2) triples; 0 mismatches in the decay
    value or the quotient."""
    from repro_torch.kernels.ts_decay import division_gate, gate_taus

    t0 = time.perf_counter()
    found = {f"{tau!r}": division_gate(dev, tau) for tau in gate_taus()}
    found["random"] = division_gate(dev, seed=17)
    secs = time.perf_counter() - t0
    bad = {k: v for k, v in found.items() if v != (0, 0)}
    check(not bad, f"division gate: 0 decay values and 0 quotients differ "
          f"from __fdiv_rn over 2^32 dividends x {len(found) - 1} taus and "
          f"2^32 random triples ({secs:.2f} s; mismatches {bad})")
    return dict(cells=(len(found)) << 32, seconds=secs, mismatches=bad)


def kernel_phase(dev, mods, words, run, prev=None):
    """Phase 2: each kernel vs its plain version, and its times; with
    ``prev`` (``build_prev``), the previous ``ts_decay`` (all three
    forms), ``stcf_support`` and ``chunk_scatter`` timed in turns with
    the current ones."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.core import edram
    from repro_torch.kernels import ref
    from repro_torch.kernels.stcf import stcf_support_cuda
    from repro_torch.kernels.ts_decay import ts_decay_cuda
    from repro_torch.kernels.ts_fused import SEGMENT, chunk_scatter_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = Timer(dev)
    engine, cfg, t_now = run["engine"], run["cfg"], run["t_end"]
    sae = engine.state.surfaces.sae
    params, v_tw = cfg.decay_params(), cfg.v_tw()
    cells = sae.numel()
    rows = []

    # -- ts_decay: the Surface product's read of the whole pool, then the
    # per-cell-plane entry at the pool's shape (tau1 and tau2 varied per
    # cell by a seeded 5 % spread); each bitwise its plain version
    v = ts_decay_cuda(sae, t_now, params)
    vr, mr = ref.ts_decay_ref(sae, t_now, params, v_tw)
    _, m = ts_decay_cuda(sae, t_now, params, v_tw)
    ulp = int(ref.ulp_distance(v, vr).max())
    near = ref.ulp_distance(vr, torch.full_like(vr, v_tw)) <= 4
    check(same(v, vr), f"ts_decay bitwise its plain version (max {ulp} "
          "ULP)")
    check(torch.equal(m, mr), f"ts_decay mask == its plain version's on "
          f"every cell ({int(near.sum())} cells within 4 ULP of v_tw)")
    g = torch.Generator(device=dev).manual_seed(4)
    eps = 1.0 + 0.05 * torch.randn((2, H, W), generator=g, device=dev)
    full = lambda x: torch.full((H, W), float(x), device=dev)
    planes = edram.DecayParams(full(params.a1), float(params.tau1) / eps[0],
                               full(params.a2), float(params.tau2) / eps[1],
                               full(params.b))
    vp = ts_decay_cuda(sae, t_now, planes)
    ulp_p = int(ref.ulp_distance(vp, ref.ts_decay_ref(sae, t_now, planes))
                .max())
    check(ulp_p == 0, f"ts_decay with (H, W) parameter planes bitwise its "
          f"plain version at {tuple(sae.shape)} (max {ulp_p} ULP)")
    old = dict(uniform=None, mask=None, planes=None)
    if prev is not None:
        pv, pm = prev_decay(prev, sae, t_now, params, v_tw)
        check(same(prev_decay(prev, sae, t_now, params), v) and same(pv, v)
              and torch.equal(pm, m)
              and same(prev_decay(prev, sae, t_now, planes), vp),
              "the previous ts_decay gives the same values and mask, "
              "uniform and planes, bitwise")
        old = dict(uniform=lambda _: prev_decay(prev, sae, t_now, params),
                   mask=lambda _: prev_decay(prev, sae, t_now, params, v_tw),
                   planes=lambda _: prev_decay(prev, sae, t_now, planes))
    ms, prev_ms = in_turns(timer, lambda _: ts_decay_cuda(
        sae, t_now, params), old["uniform"], 30, "ts_decay uniform")
    ms_mask, prev_mask = in_turns(timer, lambda _: ts_decay_cuda(
        sae, t_now, params, v_tw), old["mask"], 30, "ts_decay with mask")
    ms_planes, prev_planes = in_turns(timer, lambda _: ts_decay_cuda(
        sae, t_now, planes), old["planes"], 30, "ts_decay planes")
    plain = timer(lambda _: ref.ts_decay_ref(sae, t_now, params), 10)
    b_ms, b_by = bound_ms(8 * cells, 12 * cells)
    rnd = lambda x: x if x is None else round(x, 4)
    log(f"ts_decay: {ms:.4f} ms (previous kernel {rnd(prev_ms)} ms), plain "
        f"{plain:.4f} ms, bound {b_ms:.4f} ms; with mask {ms_mask:.4f} ms "
        f"(previous {rnd(prev_mask)} ms, bound "
        f"{bound_ms(9 * cells, 13 * cells)[0]:.4f} ms); with parameter "
        f"planes {ms_planes:.4f} ms (previous {rnd(prev_planes)} ms, bound "
        f"{bound_ms(8 * cells + 20 * H * W, 12 * cells)[0]:.4f} ms)")
    gate = division_gate_phase(dev)
    rows.append(dict(name="ts_decay", max_abs_err=float((v - vr).abs().max()),
                     max_ulp=ulp, near_threshold_cells=int(near.sum()),
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, prev_kernel_ms=prev_ms,
                     ms_with_mask=ms_mask, mask_prev_ms=prev_mask,
                     planes_ms=ms_planes, planes_prev_ms=prev_planes,
                     planes_max_ulp=ulp_p, division_gate=gate))

    # -- stcf_support: the Stcf product (fused decay + compare + count)
    s = stcf_support_cuda(sae, RADIUS, False, fused=(params, v_tw, t_now))
    sr = ref.stcf_support_fused_ref(sae, RADIUS, params, v_tw, t_now)
    near_p = ref.stcf_support_ref(near, RADIUS, include_self=True) > 0
    check(torch.equal(s[~near_p], sr[~near_p]),
          f"stcf_support fused exact away from v_tw ({int(near_p.sum())} "
          "pixels see a near-threshold cell)")
    check(torch.equal(s, stcf_support_cuda(m, RADIUS, False)),
          "stcf_support fused == ts_decay mask -> stcf_support, bitwise")
    sm = stcf_support_cuda(m, RADIUS, False)
    check(torch.equal(sm, ref.stcf_support_ref(m, RADIUS)),
          "stcf_support on the mask == its plain version")
    fused = (params, v_tw, t_now)
    old_f = old_m = None
    if prev is not None:
        check(torch.equal(prev_stcf(prev, sae, fused), s)
              and torch.equal(prev_stcf(prev, m), sm),
              "the previous stcf_support gives the same counts, both forms")
        old_f = lambda _: prev_stcf(prev, sae, fused)
        old_m = lambda _: prev_stcf(prev, m)
    ms, prev_ms = in_turns(timer, lambda _: stcf_support_cuda(
        sae, RADIUS, False, fused=fused), old_f, 30, "stcf_support fused")
    plain = timer(lambda _: ref.stcf_support_fused_ref(
        sae, RADIUS, params, v_tw, t_now), 5)
    ms_m, prev_m = in_turns(timer, lambda _: stcf_support_cuda(
        m, RADIUS, False), old_m, 30, "stcf_support mask form")
    plain_m = timer(lambda _: ref.stcf_support_ref(m, RADIUS), 5)
    k = 2 * RADIUS + 1
    ones = torch.ones((1, 1, k, k), device=dev)
    ones[..., RADIUS, RADIUS] = 0.0
    mf = m.reshape(-1, 1, H, W).float()
    conv = torch.nn.functional.conv2d(mf, ones, padding=RADIUS)
    check(torch.equal(conv.round().int().reshape(sm.shape), sm),
          "conv2d yardstick computes the same support counts")
    lib_m = timer(lambda _: torch.nn.functional.conv2d(mf, ones,
                                                       padding=RADIUS), 30)
    b_ms, b_by = bound_ms(8 * cells, (12 + 2 * k) * cells)
    log(f"stcf_support fused: {ms:.4f} ms (previous kernel "
        f"{prev_ms if prev_ms is None else round(prev_ms, 4)} ms), plain "
        f"{plain:.4f} ms, bound {b_ms:.4f} ms; mask form: {ms_m:.4f} ms "
        f"(previous {prev_m if prev_m is None else round(prev_m, 4)} ms), "
        f"plain {plain_m:.4f} ms, conv2d {lib_m:.4f} ms, bound "
        f"{bound_ms(5 * cells, 2 * k * cells)[0]:.4f} ms")
    rows.append(dict(name="stcf_support",
                     max_abs_err=float((s - sr).abs().max()),
                     near_threshold_pixels=int(near_p.sum()), ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, prev_kernel_ms=prev_ms,
                     mask_form_ms=ms_m, mask_form_prev_ms=prev_m,
                     mask_form_plain_ms=plain_m,
                     mask_form_library_ms=lib_m))

    # -- chunk_scatter: one 10 ms push of every sensor (~2 M events)
    (_, sids, fields), = engine._collect(
        [(k, np.concatenate(words[k % N_SCENES][2:4])) for k in range(S)])
    ev = ts.EventBatch(*(torch.from_numpy(f).to(dev) for f in fields))
    sids = torch.from_numpy(sids).to(dev)
    n_ev = int(ev.valid.sum())
    base = engine.state

    def fresh(_=None):
        return (base.surfaces.sae.clone(), base.cache.dirty.clone(),
                base.counts.clone(), base.surfaces.t_last.clone(),
                base.surfaces.n_events.clone())

    outs = []
    for fn in (chunk_scatter_cuda, ref.chunk_scatter_ref):
        st = fresh()
        fn(st[0], sids, ev, st[1], cfg.block, st[2], st[3], st[4])
        outs.append(st)
    exact = all(same(a, b) for a, b in zip(*outs))
    check(exact, f"chunk_scatter == its plain version on {n_ev} events: SAE, "
          "dirty, counts, t_last, n_events bitwise")
    err = torch.nan_to_num(outs[0][0] - outs[1][0], nan=0.0).abs().max()
    scat = lambda st: chunk_scatter_cuda(st[0], sids, ev, st[1], cfg.block,
                                         st[2], st[3], st[4])
    old_scat = None
    if prev is not None:
        st = fresh()
        prev_scatter(prev, st, sids, ev, cfg.block)
        check(all(same(a, b) for a, b in zip(st, outs[0])),
              "the previous chunk_scatter gives the same five outputs")
        old_scat = lambda st: prev_scatter(prev, st, sids, ev, cfg.block)
    ms, prev_ms = in_turns(timer, scat, old_scat, 30, "chunk_scatter",
                           setup=fresh)
    plain = timer(lambda st: ref.chunk_scatter_ref(
        st[0], sids, ev, st[1], cfg.block, st[2], st[3], st[4]), 5,
        setup=fresh)

    # where its time goes: (a) as timed above, L2 flushed; (b) the same
    # without the flush; (c) flushed, with no dirty marks and no counter
    # plane (the SAE, t_last and n_events only)
    sae_only = lambda st: (st[0], None, None, st[3], st[4])
    diag = {}
    for who, fn in (("kernel", scat), ("previous kernel", old_scat)):
        if fn is None:
            continue
        diag[who] = dict(
            flushed=ms if who == "kernel" else prev_ms,
            warm=timer(fn, 30, setup=fresh, flush=False),
            sae_t_only=timer(fn, 30, setup=lambda: sae_only(fresh())))
        log(f"chunk_scatter diagnosis, {who}: (a) L2 flushed "
            f"{diag[who]['flushed']:.4f} ms, (b) not flushed "
            f"{diag[who]['warm']:.4f} ms, (c) flushed, dirty = counts = "
            f"None {diag[who]['sae_t_only']:.4f} ms")
    traffic = scatter_traffic(sids, ev, tuple(base.surfaces.sae.shape),
                              cfg.block, SEGMENT)
    log(f"chunk_scatter traffic: {traffic['events']} valid events -> "
        f"{traffic['sae_atomics']} SAE atomics, {traffic['count_atomics']} "
        f"counter atomics, {traffic['dirty_stores']} dirty-mark stores "
        f"merged per {SEGMENT}-slot segment: "
        f"{traffic['per_event']:.4f} atomics per event (2 unmerged)")

    # duplicate-heavy traffic, at P = 2 on the engine's state and at P = 1
    # on a polarity-merged pool, bitwise against the plain version
    dup = {}
    for pp in (P, 1):
        d_sids, d_ev = duplicate_heavy_push(dev, S, pp)
        if pp == P:
            start = fresh
        else:
            sae1 = base.surfaces.sae.amax(dim=1, keepdim=True)
            start = lambda _=None: (
                sae1.clone(), torch.zeros((S, ops.tile_geometry(
                    H, W, cfg.block)[2]), dtype=torch.bool, device=dev),
                base.counts.clone(), base.surfaces.t_last.clone(),
                base.surfaces.n_events.clone())
        d_outs = []
        for fn in (chunk_scatter_cuda, ref.chunk_scatter_ref):
            st = start()
            fn(st[0], d_sids, d_ev, st[1], cfg.block, st[2], st[3], st[4])
            d_outs.append(st)
        d_tr = scatter_traffic(d_sids, d_ev, (S, pp, H, W), cfg.block,
                               SEGMENT)
        check(all(same(a, b) for a, b in zip(*d_outs)),
              f"chunk_scatter == its plain version on duplicate-heavy "
              f"traffic at P = {pp} ({d_tr['events']} valid events, "
              f"{d_tr['per_event']:.4f} atomics per event): SAE, dirty, "
              f"counts, t_last, n_events bitwise")
        if pp == P:
            d_scat = lambda st: chunk_scatter_cuda(
                st[0], d_sids, d_ev, st[1], cfg.block, st[2], st[3], st[4])
            d_old = None if prev is None else (lambda st: prev_scatter(
                prev, st, d_sids, d_ev, cfg.block))
            dup = dict(zip(("ms", "prev_ms"), in_turns(
                timer, d_scat, d_old, 30, "chunk_scatter, duplicate-heavy",
                setup=start)), atomics_per_event=d_tr["per_event"])
            log(f"chunk_scatter duplicate-heavy: {dup['ms']:.4f} ms "
                f"(previous kernel {dup['prev_ms']} ms)")
    ok = ev.valid & (ev.x >= 0) & (ev.x < W) & (ev.y >= 0) & (ev.y < H)
    sid = sids.long()[:, None].expand_as(ev.x)
    lin = (((sid * P + ev.p.long()) * H + ev.y.long()) * W + ev.x.long())
    lin = torch.where(ok, lin, torch.zeros_like(lin)).flatten()
    tval = torch.where(ok, ev.t, torch.full_like(ev.t, float("-inf"))).flatten()
    lib = timer(lambda st: st[0].view(-1).scatter_reduce_(
        0, lin, tval, "amax"), 30, setup=fresh)
    ys, xs = ev.y.long()[ok], ev.x.long()[ok]
    cells_hit = torch.unique(lin[ok.flatten()]).numel()
    counts_hit = torch.unique((sid[ok] * H + ys) * W + xs).numel()
    th, tw, tpl = ops.tile_geometry(H, W, cfg.block)
    tiles_hit = torch.unique(sid[ok] * (P * tpl) + (ev.p.long()[ok] * th
                             + ys // cfg.block[0]) * tw
                             + xs // cfg.block[1]).numel()
    nbytes = (17 * ev.x.numel() + 4 * sids.numel() + 8 * cells_hit
              + 8 * counts_hit + tiles_hit + 16 * S)
    b_ms, b_by = bound_ms(nbytes, 2 * n_ev)
    log(f"chunk_scatter: {ev.x.shape[0]} chunks x {CAP}, {n_ev} valid events, "
        f"{cells_hit} cells hit: {ms:.4f} ms (previous kernel "
        f"{prev_ms if prev_ms is None else round(prev_ms, 4)} ms), plain "
        f"{plain:.4f} ms, "
        f"scatter_reduce_ amax (SAE only) {lib:.4f} ms, bound {b_ms:.4f} ms "
        f"({nbytes} B)")
    rows.append(dict(name="chunk_scatter", max_abs_err=float(err),
                     bitwise=exact, events=n_ev, chunks=int(ev.x.shape[0]),
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib, prev_kernel_ms=prev_ms,
                     diagnosis=diag, traffic=traffic,
                     duplicate_heavy=dup))
    return rows


def profiled(fn):
    """Run ``fn`` once under ``torch.profiler`` (CPU + CUDA).  Returns its
    host time (ms, profiler overhead included), the summed device time of
    its kernels, their count, and the device time by PyTorch op."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    avgs = prof.key_averages()
    kernels = {e.key: e.self_device_time_total / 1e3 for e in avgs
               if e.device_type == cuda}
    return dict(wall_ms=wall, device_ms=sum(kernels.values()),
                kernels=kernels,
                launches=sum(e.count for e in avgs if e.device_type == cuda),
                ops={e.key: e.self_device_time_total / 1e3 for e in avgs
                     if e.device_type != cuda and e.key.startswith("aten::")
                     and e.self_device_time_total > 0})


def profiled_kernels(fn):
    """Run ``fn`` once under ``torch.profiler`` with the device's activity
    only, read straight from the trace (a training step launches ~320,000
    kernels: building the profiler's per-op tables with the host's
    activity took minutes).  Returns what ``profiled`` does, with the
    device time by kernel name as ``ops``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels, n = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            kernels[e.name()] = kernels.get(e.name(), 0.0) + e.duration_ns() / 1e6
            n += 1
    return dict(wall_ms=wall, device_ms=sum(kernels.values()),
                kernels=kernels, launches=n, ops=kernels)


def profile_line(what: str, r: dict, step_ms=None) -> None:
    """Log one ``profiled`` run: device time, launches, the device's idle
    share of the profiled host time (and of ``step_ms``, an unprofiled
    step, when given) and the device time of the top PyTorch ops."""
    top = sorted(r["ops"].items(), key=lambda kv: -kv[1])[:6]
    idle = f"{100 * (1 - r['device_ms'] / r['wall_ms']):.1f} % of it"
    if step_ms is not None:
        idle += (f", {100 * (1 - r['device_ms'] / step_ms):.1f} % of an "
                 f"unprofiled {step_ms:.3f} ms step")
    log(f"{what}: device kernels {r['device_ms']:.3f} ms in "
        f"{r['wall_ms']:.3f} ms profiled -> device idle {idle}; "
        f"{r['launches']} kernel launches; device ms by op: "
        f"{[(k, round(v, 3)) for k, v in top]}")


def lm_requests(cfg, request_cls):
    """The LM phase's traffic: seeded prompt lengths and tokens."""
    rng = np.random.default_rng(0)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    return [request_cls(rng.integers(0, cfg.vocab, n).astype(np.int32),
                        max_new_tokens=LM_NEW_TOKENS) for n in lens]


def timed_engine(engine):
    """Wrap a ``ServeEngine``'s prefill and decode so that each call is
    timed on the host clock ending in a synchronize.  Returns the list the
    calls land in, as (kind, seconds, decay_scan launches, logits finite),
    and the unwrapped prefill and decode."""
    from repro_torch.kernels import _lib

    calls = []
    plain_prefill, plain_decode = engine._prefill, engine._decode

    def timed(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            n0 = _lib.LAUNCHES["decay_scan"]
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            calls.append((kind, dt, _lib.LAUNCHES["decay_scan"] - n0,
                          bool(torch.isfinite(out[0]).all())))
            return out
        return run

    engine._prefill = timed("prefill", plain_prefill)
    engine._decode = timed("decode", plain_decode)
    return calls, plain_prefill, plain_decode


def run_lm(dev, card):
    """Phase 3: Mamba-2 token serving at full width and depth, bf16.
    Returns what the decay_scan kernel phase needs."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels import _lib
    from repro_torch.models import module as M
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(LM_ARCH)
    di, h, p, n = SSM.ssm_dims(cfg)
    check((cfg.d_model, di, h, p, n, cfg.vocab, T.padded_vocab(cfg))
          == (2560, 5120, 80, 64, 128, 50280, 50432)
          and cfg.activation_dtype == torch.bfloat16,
          f"{LM_ARCH} at full width: d_model {cfg.d_model}, d_inner {di}, "
          f"{h} heads x {p}, state {n}, vocab {cfg.vocab} padded to "
          f"{T.padded_vocab(cfg)}, {cfg.n_layers} layers, "
          f"{cfg.activation_dtype}")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init_params(T.param_defs(cfg), prng.PRNGKey(0), dev)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in M.flatten(params).values())
    log(f"lm on {card}: {n_params} float32 parameters "
        f"({n_params * 4 / 1e9:.2f} GB) drawn on the card from PRNGKey(0) "
        f"(the reference's key; prng threefry, one split per leaf) in "
        f"{time.perf_counter() - t0:.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    engine = ServeEngine(cfg, params, max_len=LM_PROMPT[1] + LM_NEW_TOKENS)
    reqs = lm_requests(cfg, Request)
    calls, plain_prefill, plain_decode = timed_engine(engine)
    t0 = time.perf_counter()
    engine.serve([Request(r.prompt, max_new_tokens=2) for r in reqs])
    log(f"lm: warm-up serve (same prompts, 2 tokens) "
        f"{time.perf_counter() - t0:.2f} s")
    calls.clear()
    torch.cuda.reset_peak_memory_stats(dev)

    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(reqs)
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)

    s_max = max(len(r.prompt) for r in reqs)
    prefill = [c for c in calls if c[0] == "prefill"]
    decode = [c for c in calls if c[0] == "decode"]
    real = sum(len(r.prompt) for r in reqs)
    pf_s = prefill[0][1]
    dec_ms = [c[1] * 1e3 for c in decode]
    log(f"lm on {card}: {LM_ARCH}, {cfg.n_layers} layers, {LM_REQUESTS} "
        f"requests, prompts {sorted(len(r.prompt) for r in reqs)} "
        f"(left-padded to {s_max}, {-(-s_max // cfg.ssm_chunk)} SSD chunks), "
        f"{LM_NEW_TOKENS} new tokens each; serve {wall:.3f} s")
    log(f"lm on {card}: prefill {pf_s * 1e3:.3f} ms -> "
        f"{LM_REQUESTS * s_max / pf_s:.1f} tokens/s computed "
        f"({real / pf_s:.1f} prompt tokens/s without the left padding)")
    log(f"lm on {card}: decode step p50 {np.percentile(dec_ms, 50):.3f} ms, "
        f"p99 {np.percentile(dec_ms, 99):.3f} ms, min {min(dec_ms):.3f} ms "
        f"over {len(dec_ms)} steps of batch {LM_REQUESTS} -> "
        f"{LM_REQUESTS * 1e3 / np.percentile(dec_ms, 50):.1f} tokens/s; "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log(f"lm: every decode step, ms: {[round(x, 3) for x in dec_ms]}")
    log(f"lm: kernel launches on the path: {launches}")
    check(len(prefill) == 1 and prefill[0][2] == cfg.n_layers
          and launches["decay_scan"] == cfg.n_layers,
          f"decay_scan launched n_layers = {cfg.n_layers} times by the one "
          f"prefill ({[c[2] for c in prefill]})")
    check(len(decode) == LM_NEW_TOKENS - 1 and all(c[2] == 0 for c in decode),
          f"decay_scan launched 0 times by each of {len(decode)} decode steps")
    check(all(c[3] for c in calls), "every prefill and decode logit finite")
    toks = np.stack([r.tokens for r in results])
    check(toks.shape == (LM_REQUESTS, LM_NEW_TOKENS) and toks.min() >= 0
          and toks.max() < cfg.vocab,
          f"tokens {toks.shape} within [0, vocab = {cfg.vocab})")

    # where a prefill's and a decode step's time goes: each once more under
    # torch.profiler, after the path's counts were read
    tokens = torch.zeros((LM_REQUESTS, s_max), dtype=torch.int32)
    for i, r in enumerate(reqs):
        tokens[i, s_max - len(r.prompt):] = torch.from_numpy(r.prompt)
    tokens = tokens.to(dev)
    with torch.inference_mode():
        pf = profiled(lambda: plain_prefill(params, tokens))
        _, caches, pos = plain_prefill(params, tokens)
        cur = tokens[:, -1:]
        dc = profiled(lambda: plain_decode(params, cur, caches, pos))
    scan_ms = sum(v for k, v in pf["kernels"].items() if "decay_scan" in k)
    for name, r, step_ms in (("prefill", pf, pf_s * 1e3),
                             ("decode step", dc, np.percentile(dec_ms, 50))):
        profile_line(f"lm profile, one {name}", r, step_ms)
    check(scan_ms > 0, "torch.profiler traced the prefill's decay_scan kernels")
    log(f"lm: decay_scan kernels inside one prefill: {scan_ms:.3f} ms of the "
        f"{pf_s * 1e3:.3f} ms prefill -> {100 * scan_ms / (pf_s * 1e3):.2f} % "
        f"of prefill time")
    del engine, params
    torch.cuda.empty_cache()
    lm_checks(dev, cfg, M, T, prng)
    return dict(launches=launches, b=LM_REQUESTS,
                nc=-(-s_max // cfg.ssm_chunk), c=h * p * n,
                prefill_ms=pf_s * 1e3)


def lm_checks(dev, cfg, M, T, prng):
    """The full-width model at CHECK_LAYERS layers in float32: the card
    against the CPU port on the same weights, and, on the card, the
    chunked prefill against prefill of all but the last token followed by
    one recurrent decode step."""
    cfg = dataclasses.replace(cfg, n_layers=CHECK_LAYERS, dtype="float32")
    card = M.init_params(T.param_defs(cfg), prng.PRNGKey(1), dev)
    cpu = M.unflatten({k: v.cpu() for k, v in M.flatten(card).items()})
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (CHECK_BATCH, CHECK_PROMPT),
                           generator=g, dtype=torch.int32)

    def err(a, b):
        """max |a - b|, and whether a is within rtol = LM_TOL, atol =
        LM_TOL x max(1, max|b|) of b (sums of terms of b's size cancel
        near zero)."""
        a, b = a.float().cpu(), b.float().cpu()
        scale = max(1.0, float(b.abs().max()))
        return (float((a - b).abs().max()),
                bool(torch.allclose(a, b, rtol=LM_TOL, atol=LM_TOL * scale)))

    with torch.inference_mode():
        t0 = time.perf_counter()
        lg, cg, _ = T.prefill(card, tokens.to(dev), cfg, CHECK_PROMPT,
                              last_logits_only=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lc, cc, _ = T.prefill(cpu, tokens, cfg, CHECK_PROMPT,
                              last_logits_only=True)
        t2 = time.perf_counter()
        e_logit, ok_logit = err(lg, lc)
        e_state = [err(a["ssm"]["state"], b["ssm"]["state"])
                   for a, b in zip(cg, cc)]
        check(ok_logit and all(ok for _, ok in e_state),
              f"{cfg.name} full width, {CHECK_LAYERS} layers, float32, "
              f"batch {CHECK_BATCH} x {CHECK_PROMPT} tokens: card == CPU port "
              f"within rtol = {LM_TOL}, atol = {LM_TOL} x max(1, max|CPU|) "
              f"(max |d| last logits "
              f"{e_logit:.3e} of max |logit| {float(lc.abs().max()):.3e}; "
              f"states {[f'{e:.3e}' for e, _ in e_state]}; card "
              f"{(t1 - t0) * 1e3:.1f} ms, CPU {(t2 - t1) * 1e3:.1f} ms)")
        _, caches, pos = T.prefill(card, tokens[:, :-1].to(dev), cfg,
                                   CHECK_PROMPT)
        step, sc = T.decode_step(card, tokens[:, -1:].to(dev), caches, pos,
                                 cfg)
        e_step, ok_step = err(step, lg)
        e_rec = [err(a["ssm"]["state"], b["ssm"]["state"])
                 for a, b in zip(sc, cg)]
        check(ok_step and all(ok for _, ok in e_rec),
              f"chunked prefill == prefill(prompt[:-1]) + decode_step on the "
              f"card within the same band (max |d| logits "
              f"{e_step:.3e}, states {[f'{e:.3e}' for e, _ in e_rec]})")


def decay_scan_phase(dev, lm):
    """Phase 4: decay_scan at the LM prefill's shapes vs its plain version,
    its backward at the training and prefill shapes, and their times."""
    b, t, c = lm["b"], lm["nc"], lm["c"]
    row = scan_forward(dev, b, t, c)
    log(f"decay_scan: ({b}, {t}, {c}) {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row.pop('nbytes')} B); x {lm['launches']['decay_scan']} "
        f"launches = {row['ms'] * lm['launches']['decay_scan']:.3f} ms of a "
        f"{lm['prefill_ms']:.3f} ms prefill")
    torch.cuda.empty_cache()
    bwd = decay_scan_bwd_phase(dev, [(1, TRAIN_SEQ // 128, c), (b, t, c)])
    return [dict(name="decay_scan", **row, library_ms=None, **bwd)]


def scan_forward(dev, b, t, c) -> dict:
    """``decay_scan`` at (b, t, c) on seeded inputs: bitwise against its
    plain version on the card, with and without ``s0``, and timed (L2
    flushed) beside the plain version and its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decay_scan import decay_scan_cuda

    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.exp(-torch.rand((b, t, c), generator=g, device=dev))
    x = torch.randn((b, t, c), generator=g, device=dev)
    s0 = torch.randn((b, c), generator=g, device=dev)
    st, fin = decay_scan_cuda(a, x)
    st_r, fin_r = ref.decay_scan_ref(a, x)
    st0, fin0 = decay_scan_cuda(a, x, s0)
    st0_r, fin0_r = ref.decay_scan_ref(a, x, s0)
    ok = all(same(u, v) for u, v in ((st, st_r), (fin, fin_r), (st0, st0_r),
                                     (fin0, fin0_r)))
    ulp = max(int(ref.ulp_distance(u, v).max()) for u, v in
              ((st, st_r), (fin, fin_r), (st0, st0_r), (fin0, fin0_r)))
    check(ok, f"decay_scan == its plain version bitwise at ({b}, {t}, {c}), "
          f"with and without s0 (max {ulp} ULP)")
    timer = Timer(dev)
    ms = timer(lambda _: decay_scan_cuda(a, x), 30)
    plain = timer(lambda _: ref.decay_scan_ref(a, x), 10)
    nbytes = 4 * (3 * b * t * c + b * c)
    b_ms, b_by = bound_ms(nbytes, 2 * b * t * c)
    err = float(max((st - st_r).abs().max(), (fin0 - fin0_r).abs().max()))
    return dict(max_abs_err=err, max_ulp=ulp, shape=[b, t, c], ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, nbytes=nbytes)


def decay_scan_bwd_phase(dev, shapes) -> dict:
    """Phase 4, backward: ``decay_scan_bwd`` at each (B, T, C) of
    ``shapes`` (the training microbatch's first), with and without ``s0``
    and the final state's gradient, bitwise against
    ``decay_scan_bwd_ref`` and equal in value to autograd of
    ``decay_scan_ref`` on the card (autograd sums each step's slice into
    a zero buffer, so it may hold +0 where the kernel holds -0; those
    cells are counted).  Times the first shape's backward beside its plain
    version and its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decay_scan import decay_scan_bwd_cuda

    out = {}
    for i, (b, t, c) in enumerate(shapes):
        g = torch.Generator(device=dev).manual_seed(4 + i)
        a = torch.exp(-torch.rand((b, t, c), generator=g, device=dev))
        x = torch.randn((b, t, c), generator=g, device=dev)
        s0 = torch.randn((b, c), generator=g, device=dev)
        gs = torch.randn((b, t, c), generator=g, device=dev)
        gf = torch.randn((b, c), generator=g, device=dev)
        ok, signed, worst = True, 0, 0
        for with_s0 in (False, True):
            for with_gf in (False, True):
                leaves = [v.clone().requires_grad_(True)
                          for v in (a, x) + ((s0,) if with_s0 else ())]
                st, fin = ref.decay_scan_ref(*leaves)
                outs = [st, fin] if with_gf else [st]
                want = torch.autograd.grad(outs, leaves,
                                           [gs, gf][:len(outs)])
                got = decay_scan_bwd_cuda(a, st.detach(),
                                          s0 if with_s0 else None, gs,
                                          gf if with_gf else None)
                plain = ref.decay_scan_bwd_ref(a, st.detach(),
                                               s0 if with_s0 else None, gs,
                                               gf if with_gf else None)
                for u, v, w in zip(got, plain, want):
                    if u is None:
                        continue
                    ok &= same(u, v) and torch.equal(u, w)
                    signed += int((bits(u) != bits(w)).sum())
                    worst = max(worst, float((u - w).abs().max()))
                del leaves, st, fin, want, got, plain
        check(ok, f"decay_scan_bwd at ({b}, {t}, {c}), with and without s0 "
              f"and the final-state gradient: == decay_scan_bwd_ref "
              f"bitwise, == autograd of decay_scan_ref in value "
              f"(max |d| {worst}; {signed} cells +0 there, -0 here)")
        if i == 0:
            st = ref.decay_scan_ref(a, x)[0]
            timer = Timer(dev)
            ms = timer(lambda _: decay_scan_bwd_cuda(a, st, None, gs), 30)
            plain_ms = timer(
                lambda _: ref.decay_scan_bwd_ref(a, st, None, gs), 10)
            nbytes = 4 * 5 * b * t * c
            b_ms, b_by = bound_ms(nbytes, 3 * b * t * c)
            log(f"decay_scan_bwd: ({b}, {t}, {c}) {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({nbytes} B, "
                f"{b_by})")
            out = dict(backward_shape=[b, t, c], backward_ms=ms,
                       backward_plain_ms=plain_ms, backward_bound_ms=b_ms,
                       backward_bound_by=b_by)
        del a, x, s0, gs, gf
        torch.cuda.empty_cache()
    return out


def label_band(sae, ev, cfg, stcf_mod, edram, ref, ts) -> torch.Tensor:
    """Per valid event of one sensor's labeled push from an empty slot:
    whether any cell or earlier event its STCF support compares reads
    within 2 ULP of V_tw -- replayed chunk by chunk on the CPU as the
    engine labels them (against the SAE of the earlier chunks, plus the
    chunk's own earlier events)."""
    scfg, params, v_tw = cfg.stcf_config(), cfg.decay_params(), cfg.v_tw()

    def close(dt):
        v = edram.v_mem(dt, params)
        return ref.ulp_distance(v, torch.full_like(v, v_tw)) <= 2

    out = []
    for lo in range(0, ev.x.shape[0], CAP):
        ch = ts.EventBatch(*(f[lo:lo + CAP] for f in ev))
        cell, inb = stcf_mod._patch(sae.shape, ch.x, ch.y, ch.p, scfg)
        band = (close(ch.t[:, None] - sae.reshape(-1)[cell]) & inb).any(1)
        near = (((ch.x[:, None] - ch.x[None, :]).abs() <= scfg.radius)
                & ((ch.y[:, None] - ch.y[None, :]).abs() <= scfg.radius))
        dt = ch.t[:, None] - ch.t[None, :]
        band |= (near & (dt > 0) & ch.valid[None, :]
                 & close(dt.clamp_min(0.0))).any(1)
        out.append(band[ch.valid])
        sae = ts.sae_update(sae, ch)
    return torch.cat(out)


def run_heads(dev, mods, words, card, timer):
    """Phase 5: the vision heads and labeled ingest.  Returns the heads
    path's kernel launches and what the phase measured."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.core import edram, prng
    from repro_torch.core import stcf as stcf_mod
    from repro_torch.events import datasets
    from repro_torch.kernels import ref
    from repro_torch.models import cnn
    from repro_torch.models import module as M
    from repro_torch.models.frontends import ts_stack_frontend
    from repro_torch.serve import heads

    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    spec = rs.ReadoutSpec(
        **dict(frame.products), fast=rs.surface(mode="ideal", tau=5e-3),
        logits=rs.classify(inputs=("surface", "fast"), weights=HEADS_KEY,
                           n_classes=HEADS_CLASSES, width=HEADS_WIDTH),
        labels=rs.denoise())
    cfg = eng.TSEngineConfig(h=H, w=W, polarities=P, n_slots=S,
                             chunk_capacity=CAP, mode="edram",
                             specs=(spec, frame))
    params = M.init_params(heads.head_param_defs(spec["logits"], cfg),
                           prng.PRNGKey(11), "cpu")
    heads.register_head_params(HEADS_KEY, params)
    engine = eng.TimeSurfaceEngine(cfg, device=dev)
    sessions = [engine.attach() for _ in range(S)]
    bursts = [[(sessions[k], words[k % N_SCENES][b]) for k in range(S)]
              for b in range(2 * DEADLINES)]

    torch.cuda.synchronize()
    _lib.reset_launches()
    step_ms, finite = [], True
    for d in range(DEADLINES):
        t_now = (d + 1) * DEADLINE_S
        for half in range(2):
            t0 = time.perf_counter()
            out = engine.serve_step(bursts[2 * d + half], spec, t_now)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            finite &= bool(torch.isfinite(out["logits"]).all())
    launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    t_end = DEADLINES * DEADLINE_S
    steady = step_ms[2:]
    log(f"heads on {card}: {S} sensors x {P}x{H}x{W}, FRAME + fast surface "
        f"+ Classify({HEADS_CLASSES} classes, width {HEADS_WIDTH}, "
        f"{2 * P} input channels) + Denoise, {DEADLINES} deadlines x 2 "
        f"bursts: serve_step p50 {np.percentile(steady, 50):.3f} ms, p99 "
        f"{np.percentile(steady, 99):.3f} ms over deadlines 2..{DEADLINES}; "
        f"first deadline {step_ms[0]:.3f} + {step_ms[1]:.3f} ms")
    log(f"heads: every serve_step, ms: {[round(x, 3) for x in step_ms]}")
    log(f"heads: kernel launches on the path: {launches}")
    for k, n in launches.items():
        check(n > 0, f"{k} launched on the heads path ({n})")
    check(finite, f"every logit finite at every step "
          f"({tuple(out['logits'].shape)})")

    single = engine.read(spec, t_end)
    shared = engine.read_many([spec, frame], t_end)
    check(all(same(single[n], shared[spec][n]) for n in spec.names)
          and all(same(single[n], shared[frame][n]) for n in frame.names),
          "read == read_many([heads spec, FRAME]) bitwise, every product")
    check(torch.equal(single["labels"],
                      single["stcf"] >= cfg.stcf_threshold),
          "labels == stcf >= stcf_threshold, bitwise")
    k = HEADS_CHECK_SLOTS
    t0 = time.perf_counter()
    want = cnn.cnn_apply(params, ts_stack_frontend(
        [single["surface"][:k].cpu(), single["fast"][:k].cpu()]))
    cpu_s = time.perf_counter() - t0
    got = single["logits"][:k].cpu()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, rtol=HEADS_TOL,
                              atol=HEADS_TOL * scale)),
          f"card logits of {k} slots == CPU port cnn_apply on the card's "
          f"surfaces within rtol = {HEADS_TOL}, atol = {HEADS_TOL} x max(1, "
          f"max|CPU|) (max |d| {err:.3e} of max |logit| "
          f"{float(want.abs().max()):.3e}; CPU {cpu_s * 1e3:.1f} ms)")
    _, hp = engine._resolved(spec)
    stack = ts_stack_frontend([single["surface"], single["fast"]])
    classify_ms = timer(lambda _: cnn.cnn_apply(hp["logits"], stack), 10)
    log(f"heads: Classify head alone (ts_stack_frontend + cnn_apply on "
        f"{S} slots of {H}x{W}x{2 * P}) {classify_ms:.4f} ms (CUDA events, "
        f"median of 10, L2 flushed)")

    q_spec = rs.ReadoutSpec(q=rs.ts_quantized(n_bits=16, tick=1e-3))
    q = engine.read(q_spec, t_end)["q"]
    q_ref = ref.ts_wrapped_read_ref(
        ops.ts_quantize_sae(engine.state.surfaces.sae, 16, 1e-3), t_end,
        cfg.tau, 16, 1e-3)
    q_ulp = int(ref.ulp_distance(q, q_ref).max())
    check(q_ulp <= 2, f"TsQuantized(16 bits, 1 ms) read within 2 ULP of "
          f"ts_wrapped_read_ref on the card ({q_ulp})")
    profile_line("heads profile, one serve_step (the first burst again)",
                 profiled(lambda: engine.serve_step(bursts[0], spec, t_end)),
                 np.percentile(steady, 50))
    heads.clear_registry()
    del engine, single, shared, stack

    # labeled ingest: one 10 ms push of LABEL_SENSORS sensors
    lab_cfg = eng.TSEngineConfig(h=H, w=W, polarities=P,
                                 n_slots=LABEL_SENSORS, chunk_capacity=CAP,
                                 mode="edram")
    payloads = [np.concatenate(words[k % N_SCENES][0:2])
                for k in range(LABEL_SENSORS)]
    results = {}
    for where in (dev, "cpu"):
        e = eng.TimeSurfaceEngine(lab_cfg, device=where)
        cams = [e.attach() for _ in payloads]
        torch.cuda.synchronize()
        _lib.reset_launches()
        t0 = time.perf_counter()
        labeled = [c.push_labeled(w) for c, w in zip(cams, payloads)]
        torch.cuda.synchronize()
        results[str(where)] = (labeled, time.perf_counter() - t0,
                               dict(_lib.LAUNCHES), e)
    card_lab, card_s, lab_launches, card_eng = results[str(dev)]
    cpu_lab, cpu_s, _, cpu_eng = results["cpu"]
    n_ev = sum(len(w) for w in payloads)
    excepted, mismatched = 0, 0
    for (gs, gl), (cs, cl), w in zip(card_lab, cpu_lab, payloads):
        st = aer.unpack(w, H, W)
        ev = pipeline.to_event_batch(st, st.n + (-st.n) % CAP, device="cpu")
        band = label_band(ts.empty_sae(H, W, P, "cpu"), ev, lab_cfg,
                          stcf_mod, edram, ref, ts)
        excepted += int(band.sum())
        diff = (gs.cpu() != cs) | (gl.cpu() != cl)
        mismatched += int((diff & ~band).sum())
    check(mismatched == 0,
          f"push_labeled card == CPU port on {n_ev} events of "
          f"{LABEL_SENSORS} sensors, away from the comparator band "
          f"({excepted} events excepted: a compared cell within 2 ULP of "
          f"V_tw; {mismatched} mismatched outside it)")
    check(same(card_eng.state.surfaces.sae, cpu_eng.state.surfaces.sae),
          "SAE after push_labeled, card == CPU port, bitwise")
    log(f"labels on {card}: push_labeled of {n_ev} events ({LABEL_SENSORS} "
        f"sensors x 10 ms) {card_s * 1e3:.3f} ms -> {n_ev / card_s:.1f} "
        f"events/s (CPU port {cpu_s * 1e3:.1f} ms); launches {lab_launches}")
    e = eng.TimeSurfaceEngine(lab_cfg, device=dev)
    cam = e.attach()
    profile_line("labels profile, push_labeled of sensor 0 (10 ms, "
                 f"{len(payloads[0])} events)",
                 profiled(lambda: cam.push_labeled(payloads[0])))
    del e, cam
    st0 = aer.unpack(payloads[0], H, W)
    ev0 = pipeline.to_event_batch(st0, st0.n + (-st0.n) % CAP, device=dev)
    off, off_sig = stcf_mod.stcf_chunked(
        ev0, H, W, lab_cfg.stcf_config(), chunk=CAP, mode="edram",
        params=lab_cfg.decay_params(), v_tw=lab_cfg.v_tw())
    check(torch.equal(card_lab[0][0], off[:st0.n])
          and torch.equal(card_lab[0][1], off_sig[:st0.n]),
          f"push_labeled == offline stcf_chunked(chunk={CAP}) on the card, "
          f"bitwise ({st0.n} events of sensor 0)")
    truth = datasets.dnd21_like("driving", H, W, DEADLINES * DEADLINE_S,
                                seed=0).window(0.0, DEADLINE_S)
    check(truth.n == st0.n, f"scene 0's ground truth covers its push "
          f"({truth.n} == {st0.n} events)")
    labels = torch.from_numpy(truth.is_signal)
    valid = torch.ones(st0.n, dtype=torch.bool)
    _, _, auc_card = stcf_mod.roc_curve(card_lab[0][0], labels.to(dev),
                                        valid.to(dev))
    _, _, auc_cpu = stcf_mod.roc_curve(cpu_lab[0][0], labels, valid)
    check(abs(float(auc_card) - float(auc_cpu)) <= 1e-6,
          f"roc_curve AUC card {float(auc_card):.7f} == CPU port "
          f"{float(auc_cpu):.7f} within 1e-6 (driving scene 0, 10 ms)")
    return dict(launches=launches, step_ms=step_ms, classify_ms=classify_ms,
                label_events_per_s=n_ev / card_s, auc=float(auc_card))


def gesture_sensor(k: int) -> bool:
    """The reference's ``tiered=True`` split: every third sensor (the
    glyph feeds of ``mixed_scene_feeds``) is the gesture tier."""
    return k % 3 == 2


def analog_phase(dev, mods, words, card, timer, rows):
    """Phase 6, part 1: analog reads of the sweep's spec over the full
    pool, and the three kernels at this path's shapes against their plain
    versions (results added to ``rows``)."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.kernels import ref
    from repro_torch.kernels.stcf import stcf_support_cuda
    from repro_torch.kernels.ts_decay import ts_decay_cuda
    from repro_torch.kernels.ts_fused import chunk_scatter_cuda
    from repro_torch.launch.serve import _sweep_spec
    from repro_torch.serve import fidelity as fm
    from repro_torch.serve.ts_engine import IngestRing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    specs = {name: _sweep_spec(fid, SWEEP_CLASSES) for name, fid in (
        ("analog_3d", fm.analog_3d()), ("analog_2d", fm.analog_2d()),
        ("sigma0", fm.analog_3d(sigma=0.0)), ("digital", None))}
    cfg = eng.TSEngineConfig(h=H, w=W, polarities=P, n_slots=S,
                             chunk_capacity=CAP, mode="edram",
                             specs=(specs["analog_2d"],))
    engine = eng.TimeSurfaceEngine(cfg, device=dev)
    for _ in range(S):
        engine.attach()
    payload = [np.concatenate(words[k % N_SCENES][0:2]) for k in range(S)]
    engine.push(list(enumerate(payload)))
    t_read, step = DEADLINE_S, 1
    reads = {n: engine.read(sp, t_read, noise_step=step)
             for n, sp in specs.items()}
    torch.cuda.synchronize()
    check(all(same(reads["sigma0"][n], reads["digital"][n])
              for n in specs["digital"].names),
          f"sigma = 0 analog_3d read == digital read, bitwise, every product "
          f"of the sweep spec at {S} x {P}x{H}x{W}")
    again = engine.read(specs["analog_3d"], t_read, noise_step=step)
    check(all(same(again[n], reads["analog_3d"][n])
              for n in specs["analog_3d"].names),
          "analog_3d read repeated at the same (step, generations), bitwise")
    other = engine.read(specs["analog_3d"], t_read, noise_step=step + 1)
    check(not same(other["surface"], reads["analog_3d"]["surface"]),
          "a new noise step draws other noise")

    # a sub-pool of the first sensors on the CPU port, fed the same words
    k = ANALOG_CHECK_SLOTS
    cpu = eng.TimeSurfaceEngine(dataclasses.replace(cfg, n_slots=k), "cpu")
    for _ in range(k):
        cpu.attach()
    cpu.push(list(enumerate(payload[:k])))
    v_tw = torch.full((), cfg.v_tw())
    agreement = {}
    for name in ("analog_3d", "analog_2d"):
        c = cpu.read(specs[name], t_read, noise_step=step)
        g = {n: v[:k].cpu() for n, v in reads[name].items()}
        ulp = int(ref.ulp_distance(g["surface"], c["surface"]).max())
        near = ref.ulp_distance(c["surface"],
                                v_tw.expand_as(c["surface"])) <= ANALOG_ULP
        near_p = ref.stcf_support_ref(near, RADIUS, include_self=True) > 0
        moved = (g["stcf"] != c["stcf"]) | (g["labels"] != c["labels"])
        scale = max(1.0, float(c["logits"].abs().max()))
        lg = float((g["logits"] - c["logits"]).abs().max())
        agreement[name] = dict(max_ulp=ulp, band_pixels=int(near_p.sum()),
                               moved_in_band=int((moved & near_p).sum()),
                               moved_outside=int((moved & ~near_p).sum()),
                               logits_max_abs=lg)
        check(ulp <= ANALOG_ULP and not bool((moved & ~near_p).any())
              and lg <= HEADS_TOL * scale,
              f"{name} card == CPU port on {k} sensors: surface within "
              f"{ANALOG_ULP} ULP ({ulp}), STCF counts and labels equal "
              f"outside the comparator band ({int(near_p.sum())} pixels see "
              f"a cell within {ANALOG_ULP} ULP of V_tw; "
              f"{int((moved & near_p).sum())} moved inside it), logits "
              f"within {HEADS_TOL} x max(1, max|CPU|) ({lg:.3e})")

    # times: the draw, the analog read given the draw, the digital read,
    # and the whole sweep-spec reads
    sae, params = engine.state.surfaces.sae, cfg.decay_params()
    fid = fm.analog_3d()
    eps = fm.cell_eps(fid, step, engine.state.generation, sae.shape[1:])
    eps_ms = timer(lambda _: fm.cell_eps(fid, step, engine.state.generation,
                                         sae.shape[1:]), 5)
    analog_ms = timer(lambda _: ops.ts_analog_read(sae, t_read, params,
                                                   eps=eps), 20)
    digital_ms = timer(lambda _: ops.ts_decay(sae, t_read, params), 20)
    spec_ms = {n: timer(lambda _, sp=specs[n]: engine.read(
        sp, t_read, noise_step=step), 5) for n in ("analog_3d", "digital")}
    log(f"analog on {card}: cell_eps ({S} x {P}x{H}x{W} normals) "
        f"{eps_ms:.4f} ms; ts_analog_read given eps {analog_ms:.4f} ms; "
        f"digital ts_decay {digital_ms:.4f} ms; whole sweep-spec read "
        f"analog_3d {spec_ms['analog_3d']:.4f} ms, digital "
        f"{spec_ms['digital']:.4f} ms (CUDA events, median, L2 flushed)")

    # the kernels at this path's shapes against their plain versions
    dt = t_read - sae
    virtual = torch.where(torch.isfinite(sae), -(dt * eps),
                          torch.full_like(sae, ts.NEVER))
    vv = ts_decay_cuda(virtual, 0.0, params)
    v_ulp = int(ref.ulp_distance(vv, ref.ts_decay_ref(virtual, 0.0,
                                                      params)).max())
    check(v_ulp <= 2, f"ts_decay on the virtual SAE (ages dt * eps) within "
          f"2 ULP of its plain version ({v_ulp})")
    m = vv > cfg.v_tw()
    sm = stcf_support_cuda(m, RADIUS, False)
    check(torch.equal(sm, ref.stcf_support_ref(m, RADIUS)),
          "stcf_support mask form on the analog mask == its plain version")
    virtual_ms = timer(lambda _: ts_decay_cuda(virtual, 0.0, params), 30)
    mask_ms = timer(lambda _: stcf_support_cuda(m, RADIUS, False), 30)
    ring = IngestRing(CAP, dev)
    parts = []
    for k2 in range(S):
        st0 = aer.unpack(words[k2 % N_SCENES][2], H, W)
        parts += [(k2, tuple(f[i:i + CAP] for f in (st0.x, st0.y, st0.t,
                                                     st0.p)))
                  for i in range(0, st0.n, CAP)]
    buf = ring.acquire(len(parts))
    for i, (slot, part) in enumerate(parts):
        IngestRing.fill_row(buf, i, slot, part)
    sids, ev = ring.upload(buf)
    base = engine.state
    outs = []
    for fn in (chunk_scatter_cuda, ref.chunk_scatter_ref):
        st1 = (base.surfaces.sae.clone(), base.cache.dirty.clone(),
               base.counts.clone(), base.surfaces.t_last.clone(),
               base.surfaces.n_events.clone())
        fn(st1[0], sids, ev, st1[1], cfg.block, st1[2], st1[3], st1[4])
        outs.append(st1)
    check(all(same(a, b) for a, b in zip(*outs)),
          f"chunk_scatter on one ring-staged push ({len(parts)} rows, "
          f"{int(ev.valid.sum())} events) == its plain version, bitwise")
    log(f"analog kernels: ts_decay on the virtual SAE {virtual_ms:.4f} ms, "
        f"stcf_support on the analog mask {mask_ms:.4f} ms")
    for row in rows:
        if row["name"] == "ts_decay":
            row.update(virtual_sae_ms=virtual_ms, virtual_sae_max_ulp=v_ulp)
        elif row["name"] == "stcf_support":
            row.update(analog_mask_ms=mask_ms)

    # ring against host push of the same parts, in turns
    def push_ms(staged):
        e = eng.TimeSurfaceEngine(cfg, device=dev)
        for _ in range(S):
            e.attach()
        streams = [(slot, aer.unpack(words[slot % N_SCENES][2], H, W))
                   for slot in range(S)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if staged:
            e.push_staged(parts)
        else:
            e.push(streams)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    turns = [push_ms(staged) for staged in (True, False) * 2
             for _ in range(2)]
    ring_ms = float(np.median(turns[0::2]))
    host_ms = float(np.median(turns[1::2]))
    log(f"ingest on {card}: one 5 ms push of {S} sensors, ring (pinned, "
        f"staged parts) {ring_ms:.3f} ms vs host-staged push (EventStreams) "
        f"{host_ms:.3f} ms, medians of 4 in turns: "
        f"{[round(x, 3) for x in turns]}")
    return dict(cell_eps_ms=eps_ms, analog_ms=analog_ms,
                digital_ms=digital_ms, spec_ms=spec_ms, ring_ms=ring_ms,
                host_ms=host_ms, agreement=agreement)


def stream_phase(dev, mods, words, card):
    """Phase 6, part 2: the streaming runtime over the full pool.  Returns
    the stream path's kernel launches and what it measured."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.events import replay as rp
    from repro_torch.launch.serve import _sweep_spec
    from repro_torch.serve import fidelity as fm
    from repro_torch.serve import stream as st

    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    gesture = _sweep_spec(fm.analog_3d(), SWEEP_CLASSES)
    cfg = eng.TSEngineConfig(h=H, w=W, polarities=P, n_slots=S,
                             chunk_capacity=CAP, mode="edram",
                             specs=(frame, gesture))
    tiers = {True: dataclasses.replace(st.GESTURE_TIER, spec=gesture),
             False: st.TELEMETRY_TIER}
    streams = [aer.unpack(np.concatenate(words[j][:2 * STREAM_DEADLINES]),
                          H, W) for j in range(N_SCENES)]
    feeds = [rp.SensorFeed(stream=streams[k % N_SCENES], name=f"sensor-{k}",
                           qos=tiers[gesture_sensor(k)]) for k in range(S)]
    t_end = STREAM_DEADLINES * DEADLINE_S - 1e-6
    scfg = st.StreamConfig(policy="drop_oldest", deadline_s=DEADLINE_S,
                           pipeline=True, device_ring=True)

    def make():
        return eng.TimeSurfaceEngine(cfg, device=dev)

    def run(**over):
        return rp.replay(make(), feeds, dataclasses.replace(scfg, **over),
                         frame, arrival_substeps=STREAM_SUBSTEPS, t_end=t_end)

    rp.replay(make(), feeds, scfg, frame, arrival_substeps=STREAM_SUBSTEPS,
              t_end=1.5 * DEADLINE_S)          # first-touch costs
    torch.cuda.synchronize()
    _lib.reset_launches()
    report = run()
    launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    log(f"stream on {card}: {S} sensors ({sum(map(gesture_sensor, range(S)))}"
        f" gesture on the analog_3d sweep spec, the rest telemetry on "
        f"FRAME), {report.n_steps} deadlines x {DEADLINE_S * 1e3:.0f} ms, "
        f"{STREAM_SUBSTEPS} arrival substeps, drop_oldest, pipelined, ring:")
    for line in report.summary().splitlines():
        log(f"  {line}")
    energy = {}
    for tier, mode in (("gesture", "analog_3d"), ("telemetry", "ideal")):
        row, e = report.tiers[tier], report.tier_energy_uj[tier]
        energy[mode] = e["total_uj"] * 1e3 / max(row["ingested"], 1)
        log(f"stream tier {tier} ({mode}): ingested {row['ingested']}, "
            f"readout latency p50 {row['latency_p50_us'] / 1e3:.3f} ms, p99 "
            f"{row['latency_p99_us'] / 1e3:.3f} ms; modeled energy "
            f"{energy[mode]:.6f} nJ/event")
        check(row["offered"] == row["ingested"] + row["dropped"]
              + row["refused"] + row["discarded"] + row["deferred"],
              f"tier {tier} conserves: offered {row['offered']} == ingested "
              f"+ dropped + refused + discarded + deferred")
    log(f"stream: events/s {report.events_per_sec:.1f}; kernel launches on "
        f"the stream path: {launches}")
    for k, n in launches.items():
        check(n > 0, f"{k} launched on the stream path ({n})")
    try:
        n = rp.check_oracle(report, make, frame)
        check(n == report.n_steps, f"stream digests == the synchronous "
              f"oracle's on the card, bitwise, at all {n} deadlines")
    except AssertionError as err:
        check(False, f"stream oracle gate on the card: {err}")
    host = run(device_ring=False)
    check(host.digests == report.digests,
          "the same stream with device_ring=False gives the same digests")

    # one step under the profiler: push (ring) + both specs' reads + the
    # previous step's digest
    rt = st.StreamRuntime(make(), scfg, frame)
    sensors = [rt.connect(f.qos) for f in feeds]

    def offer(d):
        for sen, f in zip(sensors, feeds):
            w = f.stream.window(d * DEADLINE_S, (d + 1) * DEADLINE_S)
            sen.offer((w.x, w.y, w.t, w.p))

    offer(0)
    rt.step(DEADLINE_S)
    offer(1)
    rt.step(2 * DEADLINE_S)
    offer(2)
    prof = profiled(lambda: (rt.step(3 * DEADLINE_S), rt.flush()))
    profile_line("stream profile, one step (ring push, FRAME + analog sweep "
                 "spec, the previous step's digest)", prof)
    return dict(launches=launches, events_per_s=report.events_per_sec,
                tiers={t: {k: report.tiers[t][k] for k in
                           ("ingested", "dropped", "latency_p50_us",
                            "latency_p99_us")} for t in report.tiers},
                energy_nj_per_event=energy,
                idle_share=1 - prof["device_ms"] / prof["wall_ms"])


def log_view(log):
    """A device-neutral view of an action log: QoS classes by tier, step
    records by their schedule, flags and chunk contents."""
    out = []
    for kind, e in log:
        if kind in ("attach", "set_tier"):
            out.append((kind, e[0], e[1].tier))
        elif kind == "shrink":
            out.append((kind, e[0], [tuple(m) for m in e[1]]))
        elif kind == "step":
            out.append((kind, e.t_read, e.n_events, e.n_chunks, e.order,
                        e.deferred, e.overload, e.noise_step, e.barrier,
                        [(slot, [np.asarray(a).tobytes() for a in part])
                         for slot, part in e.chunks]))
        else:
            out.append((kind, e))
    return out


def migrated_tiers(log):
    """The tier of each sensor a ``migrate`` moved, in log order (slots
    followed through attaches, tier changes, detaches and shrinks)."""
    tier_of, moved = {}, []
    for kind, e in log:
        if kind in ("attach", "set_tier"):
            tier_of[e[0]] = e[1].tier
        elif kind == "detach":
            tier_of.pop(e)
        elif kind == "migrate":
            tier_of[e[1]] = tier_of.pop(e[0])
            moved.append(tier_of[e[1]])
        elif kind == "shrink":
            for src, dst in e[1]:
                tier_of[dst] = tier_of.pop(src)
    return moved


def timed_op(fn, devices=()):
    """(result, device ms from CUDA events on the current card, host ms
    ending in a synchronize of it and of every card in ``devices``) of
    one call."""
    for d in (None, *devices):
        torch.cuda.synchronize(d)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    for d in devices:
        torch.cuda.synchronize(d)
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def fleet_moves(dev, mods, words, card, frame):
    """Phase 7, part 1: one grow, one migrate and one shrink with
    compaction of a 21-slot QVGA pool, timed; cached ``serve_step`` ==
    the dense read bitwise after each."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    cfg = eng.TSEngineConfig(h=H, w=W, polarities=P, n_slots=FLEET_BUCKET,
                             slot_bucket=FLEET_BUCKET, chunk_capacity=CAP,
                             mode="edram", specs=(frame,),
                             max_dirty_tiles=1 << 30)
    engine = eng.TimeSurfaceEngine(cfg, device=dev)
    for _ in range(FLEET_BUCKET):
        engine.attach()
    t_now = DEADLINES * DEADLINE_S
    burst = 0

    def serve(what):
        nonlocal burst
        live = sorted(engine._sessions)
        items = [(s, words[s % N_SCENES][burst % (2 * DEADLINES)])
                 for s in live]
        burst += 1
        got = engine.serve_step(items, frame, t_now)["surface"]
        dense = engine.read(rs.SURFACE_SPEC, t_now)["surface"]
        check(same(got, dense), f"fleet: cached serve_step == dense read "
              f"bitwise after {what} ({len(live)} live of "
              f"{engine.capacity} slots)")

    serve("the first fill")
    cap, g_dev, g_host = timed_op(engine.grow)
    serve(f"a grow to {cap}")
    dst, m_dev, m_host = timed_op(lambda: engine.migrate(5))
    serve(f"a migrate 5 -> {dst}")
    moves, s_dev, s_host = timed_op(lambda: engine.shrink(FLEET_BUCKET))
    check(moves == [(dst, 5)], f"fleet: the shrink compacts {moves}")
    serve(f"a shrink to {engine.capacity}")
    ops_ms = {"grow": (g_dev, g_host), "migrate": (m_dev, m_host),
              "shrink": (s_dev, s_host)}
    log(f"fleet moves on {card}: grow {FLEET_BUCKET} -> {cap} slots at "
        f"{P}x{H}x{W} device {g_dev:.4f} ms, host {g_host:.4f} ms; "
        f"migrate 5 -> {dst} device {m_dev:.4f} ms, host {m_host:.4f} ms; "
        f"shrink {cap} -> {engine.capacity} with moves {moves} device "
        f"{s_dev:.4f} ms, host {s_host:.4f} ms")
    return ops_ms


def fleet_cfgs(eng, st, frame, h, w):
    cfg = eng.TSEngineConfig(h=h, w=w, polarities=P, n_slots=FLEET_BUCKET,
                             slot_bucket=FLEET_BUCKET, chunk_capacity=CAP,
                             mode="edram", specs=(frame,))
    scfg = st.StreamConfig(policy="drop_oldest", deadline_s=DEADLINE_S,
                           pipeline=True, device_ring=True, elastic=True,
                           shrink_watermark=0.9,
                           shard_budget=FLEET_SHARD_BUDGET,
                           shard_barrier_every=FLEET_BARRIER_EVERY)
    return cfg, scfg


def fleet_phase(dev, mods, words, card, stream6):
    """Phase 7: the elastic pool and live migration on the card.  Returns
    the fleet path's kernel launches and what it measured."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.events import replay as rp
    from repro_torch.serve import stream as st

    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    ops_ms = fleet_moves(dev, mods, words, card, frame)
    duration = DEADLINES * DEADLINE_S
    t0 = time.perf_counter()
    feeds = rp.fleet_scene_feeds(H, W, duration, FLEET_SENSORS,
                                 n_moves=FLEET_MOVES)
    log(f"fleet: {FLEET_SENSORS} feeds, {sum(f.stream.n for f in feeds)} "
        f"events, made in {time.perf_counter() - t0:.2f} s")
    cfg, scfg = fleet_cfgs(eng, st, frame, H, W)

    def make():
        return eng.TimeSurfaceEngine(cfg, device=dev)

    rp.replay(make(), feeds, scfg, frame, arrival_substeps=STREAM_SUBSTEPS,
              t_end=1.5 * DEADLINE_S)          # first-touch costs
    torch.cuda.synchronize()
    _lib.reset_launches()
    report = rp.replay(make(), feeds, scfg, frame,
                       arrival_substeps=STREAM_SUBSTEPS)
    launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    fleet_log = [(k, e) for k, e in report.log
                 if k in ("grow", "shrink", "migrate")]
    log(f"fleet on {card}: {FLEET_SENSORS} sensors, pool of {FLEET_BUCKET} "
        f"slots growing by {FLEET_BUCKET}, shard budget "
        f"{FLEET_SHARD_BUDGET}, a barrier every {FLEET_BARRIER_EVERY}, "
        f"{report.n_steps} deadlines x {DEADLINE_S * 1e3:.0f} ms:")
    for line in report.summary().splitlines():
        log(f"  {line}")
    log(f"fleet log: {fleet_log}")
    kinds = [k for k, _ in fleet_log]
    moves = [m for k, e in fleet_log if k == "shrink" for m in e[1]]
    check(kinds.count("grow") >= 2 and kinds.count("shrink") >= 1
          and moves and kinds.count("migrate") >= FLEET_MOVES,
          f"fleet log: {kinds.count('grow')} grows, {kinds.count('shrink')} "
          f"shrinks with {len(moves)} moves, {kinds.count('migrate')} "
          f"migrates (>= 2, >= 1 with >= 1, >= {FLEET_MOVES})")
    moved_tiers = migrated_tiers(report.log)
    check("gesture" in moved_tiers,
          f"fleet: a gesture (analog, head-bearing) slot migrated (tiers "
          f"of the moved sensors: {moved_tiers})")
    for tier, row in sorted(report.tiers.items()):
        check(row["offered"] == row["ingested"] + row["dropped"]
              + row["refused"] + row["discarded"] + row["deferred"],
              f"fleet tier {tier} conserves: offered {row['offered']} == "
              f"ingested + dropped + refused + discarded + deferred "
              f"(migrated {row['migrated']})")
    for k, n in launches.items():
        check(n > 0, f"{k} launched on the fleet path ({n})")
    try:
        n = rp.check_oracle(report, make, frame)
        check(n == report.n_steps, f"fleet digests == the synchronous "
              f"oracle's on the card, bitwise, at all {n} deadlines, its "
              f"shrink deriving the logged moves {moves}")
    except AssertionError as err:
        check(False, f"fleet oracle gate on the card: {err}")
    for tier in sorted(report.tiers):
        row = report.tiers[tier]
        was = stream6["tiers"].get(tier, {})
        log(f"fleet tier {tier}: ingested {row['ingested']}, migrated "
            f"{row['migrated']}, readout latency p50 "
            f"{row['latency_p50_us'] / 1e3:.3f} ms, p99 "
            f"{row['latency_p99_us'] / 1e3:.3f} ms (phase 6, fixed pool of "
            f"{S}: p50 {was.get('latency_p50_us', float('nan')) / 1e3:.3f} "
            f"ms, p99 {was.get('latency_p99_us', float('nan')) / 1e3:.3f} ms)")
    log(f"fleet: events/s {report.events_per_sec:.1f} (phase 6, fixed "
        f"pool: {stream6['events_per_s']:.1f}); kernel launches on the "
        f"fleet path: {launches}")
    fleet_small(dev, mods, frame)
    fleet_cli()
    return feeds, dict(launches=launches, events_per_s=report.events_per_sec,
                tiers={t: {k: report.tiers[t][k] for k in
                           ("ingested", "dropped", "migrated",
                            "latency_p50_us", "latency_p99_us")}
                       for t in report.tiers},
                log=[(k, e) for k, e in fleet_log], moves_ms=ops_ms)


def fleet_small(dev, mods, frame):
    """Phase 7, part 3: the same fleet feeds at 60x80 on the card and on a
    CPU engine: equal action logs, counters, tier counters and final
    integer state (SAE bits, counts)."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.events import replay as rp
    from repro_torch.serve import stream as st

    h, w = FLEET_SMALL_HW
    cfg, scfg = fleet_cfgs(eng, st, frame, h, w)
    feeds = rp.fleet_scene_feeds(h, w, DEADLINES * DEADLINE_S, FLEET_SENSORS,
                                 n_moves=FLEET_MOVES)
    runs = []
    for where in (dev, torch.device("cpu")):
        engine = eng.TimeSurfaceEngine(cfg, device=where)
        rep = rp.replay(engine, feeds, scfg, frame,
                        arrival_substeps=STREAM_SUBSTEPS)
        state = engine.state
        runs.append((rep, bits(state.surfaces.sae).cpu(), state.counts.cpu()))
    (g, g_sae, g_cnt), (c, c_sae, c_cnt) = runs
    keys = ("offered", "accepted", "ingested", "dropped", "refused",
            "discarded", "migrated")
    strip = lambda t: {k: {f: v for f, v in r.items() if "latency" not in f}
                       for k, r in t.items()}
    check(log_view(g.log) == log_view(c.log)
          and all(getattr(g, k) == getattr(c, k) for k in keys)
          and strip(g.tiers) == strip(c.tiers)
          and torch.equal(g_sae, c_sae) and torch.equal(g_cnt, c_cnt),
          f"fleet at {h}x{w}: card == CPU engine: action log "
          f"({len(g.log)} entries), counters, tier counters (migrated "
          f"{g.migrated}) and final SAE bits and counts")


def fleet_cli():
    """Phase 7, part 4: the ``stream --migrate-demo`` CLI in a subprocess
    on the card."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "stream",
         *FLEET_CLI_ARGV], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True,
        text=True, timeout=SWEEP_TIMEOUT_S)
    for line in proc.stdout.splitlines():
        if not line.startswith("feed "):
            log(f"  migrate-demo | {line}")
    if proc.returncode:
        log(proc.stderr[-4000:])
    check(proc.returncode == 0
          and "bitwise oracle gate: OK" in proc.stdout
          and "fleet ops: grow->" in proc.stdout,
          f"stream --migrate-demo CLI on the card: exit {proc.returncode}, "
          f"oracle gate OK, fleet ops printed "
          f"({time.perf_counter() - t0:.1f} s)")


class ShardLaunches:
    """Each kernel's launches per shard of one engine: while active, the
    three kernels' wrappers (``kernels.ts_decay.ts_decay_cuda``,
    ``kernels.stcf.stcf_support_cuda``, ``kernels.ts_fused.
    chunk_scatter_cuda``) are wrapped so that the launches one call adds
    to ``_lib.LAUNCHES`` are credited to the shard whose SAE the call
    reads or writes (launches on anything else, such as the gathered
    dirty tiles, go to ``None``).  ``paused()`` credits nothing, and puts
    ``_lib.LAUNCHES`` back as it was, around check reads."""

    WRAPPED = (("repro_torch.kernels.ts_decay", "ts_decay_cuda", "ts_decay"),
               ("repro_torch.kernels.stcf", "stcf_support_cuda",
                "stcf_support"),
               ("repro_torch.kernels.ts_fused", "chunk_scatter_cuda",
                "chunk_scatter"))

    def __init__(self, _lib, engine):
        self._lib, self.engine = _lib, engine
        self.counts: dict = {}
        self._active = True
        self._saved = []

    def _wrap(self, fn, kernel):
        def wrapped(x, *args, **kw):
            before = self._lib.LAUNCHES[kernel]
            out = fn(x, *args, **kw)
            if self._active:
                shard = {st.surfaces.sae.data_ptr(): k for k, st in
                         enumerate(self.engine._states)}.get(x.data_ptr())
                key = (shard, kernel)
                self.counts[key] = (self.counts.get(key, 0)
                                    + self._lib.LAUNCHES[kernel] - before)
            return out
        return wrapped

    def __enter__(self):
        for mod, attr, kernel in self.WRAPPED:
            m = importlib.import_module(mod)
            self._saved.append((m, attr, getattr(m, attr)))
            setattr(m, attr, self._wrap(getattr(m, attr), kernel))
        return self

    def __exit__(self, *exc):
        for m, attr, fn in self._saved:
            setattr(m, attr, fn)

    @contextlib.contextmanager
    def paused(self):
        snap = dict(self._lib.LAUNCHES)
        self._active = False
        try:
            yield
        finally:
            self._active = True
            self._lib.LAUNCHES.update(snap)

    def per_shard(self, n_shards):
        return [{k: self.counts.get((shard, k), 0) for k in ENGINE_KERNELS}
                for shard in range(n_shards)]


class HostSpans:
    """Host time of a ``serve_step``'s parts on one engine, split
    exclusively (a span's time less the spans inside it): while active,
    the engine's ``_item_chunks`` (host chunking), ``_plan.route``,
    ``push`` (what is left of it: the uploads and the scatter launches),
    ``read`` (the products read after the surface), ``_gather`` (products
    onto shard 0), ``ops.ts_fused_dirty`` (the dirty-tile refresh) and
    ``torch.nonzero`` (its host sync) are wrapped with the host clock."""

    def __init__(self, ops, engine):
        self._targets = [(engine, "_item_chunks", "chunking"),
                         (engine._plan, "route", "route"),
                         (engine, "push", "uploads + scatter"),
                         (engine, "read", "other reads"),
                         (engine, "_gather", "gather"),
                         (ops, "ts_fused_dirty", "refresh"),
                         (torch, "nonzero", "nonzero sync")]
        self.ms = {name: 0.0 for _, _, name in self._targets}
        self.active = True
        self._stack = []
        self._saved = []

    def _wrap(self, fn, name):
        def wrapped(*args, **kw):
            if not self.active:
                return fn(*args, **kw)
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = (time.perf_counter() - t0) * 1e3
                inner = self._stack.pop()
                self.ms[name] += dt - inner
                if self._stack:
                    self._stack[-1] += dt
        return wrapped

    def __enter__(self):
        for obj, attr, name in self._targets:
            fn = getattr(obj, attr)
            self._saved.append((obj, attr, obj.__dict__.get(attr), fn))
            setattr(obj, attr, self._wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for obj, attr, own, fn in reversed(self._saved):
            if own is None:       # a bound method: drop the wrapper
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)

    def per_step(self, n_steps: int, step_ms: float) -> dict:
        out = {k: v / n_steps for k, v in self.ms.items()}
        out["rest of serve_step"] = step_ms / n_steps - sum(out.values())
        return out


def shard_loop(dev, mods, words, run, n_shards, card, devices=None,
               profile=False):
    """Phase 8 (a): phase 1's FRAME loop on an ``n_shards`` engine, the
    shards cycling over ``devices`` (default: all on ``dev``), each with
    tensors of its own.  Each step's products against phase 1's on the
    same words, bitwise; incremental == dense at every deadline; launches
    per shard; the host time of a step by part (``HostSpans``), and with
    ``profile`` two more steps under ``torch.profiler``."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.launch.mesh import make_host_mesh

    frame, cfg = run["frame"], run["cfg"]
    mesh = make_host_mesh(n_shards, devices=devices or [dev])
    engine = eng.TimeSurfaceEngine(cfg, mesh=mesh)
    sessions = [engine.attach() for _ in range(S)]
    scene_of = [k % N_SCENES for k in range(S)]
    bursts = [[(sessions[k], words[scene_of[k]][b]) for k in range(S)]
              for b in range(2 * DEADLINES)]
    ptrs = {st.surfaces.sae.data_ptr() for st in engine._states}
    check(engine.n_slots_padded == -(-S // n_shards) * n_shards,
          f"shards: {S} slots pad to {engine.n_slots_padded} on "
          f"{n_shards} shards")
    check(len(ptrs) == n_shards and all(
        st.surfaces.sae.device == d
        for st, d in zip(engine._states, mesh.devices)),
        f"shards: {mesh.placement()}, each with an SAE of its own")
    step_ms, differ, mismatched = [], [], []
    t_wall = 0.0
    torch.cuda.synchronize()
    _lib.reset_launches()
    with ShardLaunches(_lib, engine) as sl, HostSpans(ops, engine) as hs:
        for d in range(DEADLINES):
            t_now = (d + 1) * DEADLINE_S
            for half in range(2):
                b = 2 * d + half
                if b == 2:   # spans over the steady steps only
                    hs.ms = dict.fromkeys(hs.ms, 0.0)
                t0 = time.perf_counter()
                out = engine.serve_step(bursts[b], frame, t_now)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                t_wall += dt
                step_ms.append(dt * 1e3)
                want = run["step_outs"][b]
                if not all(same(out[k][:S], want[k])
                           and not bits(out[k][S:]).any() for k in want):
                    differ.append(b)
            with sl.paused():
                hs.active = False
                dense = engine.read(rs.SURFACE_SPEC, t_now)["surface"]
                hs.active = True
                if not same(out["surface"], dense):
                    mismatched.append(d)
        launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    per_shard = sl.per_shard(n_shards)
    n_events = sum(engine.stats()["n_events"])
    steady = step_ms[2:]
    spans = hs.per_step(len(steady), sum(steady))
    res = dict(n_shards=n_shards, events_per_s=n_events / t_wall,
               p50_ms=float(np.percentile(steady, 50)),
               p99_ms=float(np.percentile(steady, 99)), launches=launches,
               launches_per_shard=per_shard, n_events=n_events,
               host_ms_per_step=spans)
    log(f"shards on {card}: FRAME loop on {n_shards} shard(s) of "
        f"{engine._plan.slots_per_shard} slots ({mesh.placement()}): "
        f"{n_events} "
        f"events in {t_wall:.4f} s -> {res['events_per_s']:.1f} events/s; "
        f"serve_step p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms "
        f"over deadlines 2..{DEADLINES} (phase 1, unsharded: "
        f"{run['events_per_s']:.1f} events/s)")
    log(f"shards: {n_shards}-shard launches {launches}, per shard "
        f"{per_shard}")
    log(f"shards: host ms of a steady serve_step by part on {n_shards} "
        f"shard(s), mean of {len(steady)}: "
        f"{ {k: round(v, 4) for k, v in spans.items()} }")
    if profile:
        # one dense and one incremental step under torch.profiler, after
        # the path's counts were read: kernel launches and device idle
        t_now = (DEADLINES + 1) * DEADLINE_S
        prof = profiled(lambda: [engine.serve_step(bursts[b], frame, t_now)
                                 for b in (0, 1)])
        profile_line(f"shards profile, {n_shards} shard(s), two steps "
                     f"(dense + incremental)", prof)
        res["profile"] = dict(launches=prof["launches"],
                              device_ms=prof["device_ms"],
                              wall_ms=prof["wall_ms"])
    check(not differ, f"{n_shards}-shard FRAME products == phase 1's "
          f"unsharded products, bitwise, at every step (differ: {differ})")
    check(not mismatched, f"{n_shards}-shard incremental serve_step == "
          f"dense read, bitwise, at every deadline ({mismatched})")
    check(n_events == run["n_events"], f"{n_shards}-shard events ingested "
          f"{n_events} == phase 1's {run['n_events']}")
    live = sorted({engine._plan.shard_of(c.slot) for c in sessions})
    check(all(per_shard[k][name] > 0 for k in live
              for name in ENGINE_KERNELS),
          f"every kernel launched on every shard holding sensors "
          f"({len(live)} of {n_shards})")
    route_ms = []
    for b in range(2 * DEADLINES):
        parts = engine._item_chunks(bursts[b])
        t0 = time.perf_counter()
        engine._plan.route(parts)
        route_ms.append((time.perf_counter() - t0) * 1e3)
    res["route_ms_p50"] = float(np.percentile(route_ms, 50))
    log(f"shards: host time of route (grouping by shard, stacking each "
        f"shard's fields) over {n_shards} shard(s), median of "
        f"{len(route_ms)} bursts: {res['route_ms_p50']:.4f} ms")
    return res


def shard_fleet(dev, mods, card, feeds, n_shards=2, devices=None):
    """Phase 8 (b): phase 7's elastic fleet on an ``n_shards`` engine (21
    slots pad to 22 on 2 shards: a dead tail) under the multi-shard EDF
    scheduler, the shards cycling over ``devices`` (default: ``dev``)."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.events import replay as rp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import stream as st

    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    cfg, scfg = fleet_cfgs(eng, st, frame, H, W)
    mesh = make_host_mesh(n_shards, devices=devices or [dev])

    def make():
        return eng.TimeSurfaceEngine(cfg, mesh=mesh)

    rp.replay(make(), feeds, scfg, frame, arrival_substeps=STREAM_SUBSTEPS,
              t_end=1.5 * DEADLINE_S)          # first-touch costs
    engine = make()
    check(engine.n_slots_padded == -(-FLEET_BUCKET // n_shards) * n_shards,
          f"shards: a {FLEET_BUCKET}-slot pool pads to "
          f"{engine.n_slots_padded} on {n_shards} shards")
    torch.cuda.synchronize()
    _lib.reset_launches()
    with ShardLaunches(_lib, engine) as sl:
        report = rp.replay(engine, feeds, scfg, frame,
                           arrival_substeps=STREAM_SUBSTEPS)
        launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    per_shard = sl.per_shard(n_shards)
    fleet_log = [(k, e) for k, e in report.log
                 if k in ("grow", "shrink", "migrate")]
    capacity, crossing = FLEET_BUCKET, []
    for k, e in fleet_log:
        if k == "grow":
            capacity = e
        elif k == "shrink":
            capacity = e[0]
        else:
            sps = -(-capacity // n_shards)
            crossing.append((e, e[0] // sps, e[1] // sps))
    log(f"shards fleet on {card}: {mesh.placement()}, {report.n_steps} "
        f"deadlines:")
    for line in report.summary().splitlines():
        log(f"  {line}")
    log(f"shards fleet log: {fleet_log}; migrations (move, from shard, to "
        f"shard): {crossing}; launches {launches}, per shard {per_shard}")
    check(any(a != b for _, a, b in crossing),
          f"shards fleet: a migration crosses shards ({crossing})")
    steps = [e for k, e in report.log if k == "step"]
    barriers = [i for i, e in enumerate(steps) if e.barrier]
    check(barriers == [i for i in range(len(steps))
                       if (i + 1) % FLEET_BARRIER_EVERY == 0],
          f"shards fleet: barrier steps every {FLEET_BARRIER_EVERY}th "
          f"deadline ({barriers} of {len(steps)})")
    for tier, row in sorted(report.tiers.items()):
        check(row["offered"] == row["ingested"] + row["dropped"]
              + row["refused"] + row["discarded"] + row["deferred"],
              f"shards fleet tier {tier} conserves: offered "
              f"{row['offered']} == ingested + dropped + refused + "
              f"discarded + deferred")
    check(all(per[k] > 0 for per in per_shard for k in ENGINE_KERNELS),
          f"shards fleet: every kernel launched on all {n_shards} shards")
    slow = latency_outliers(report)
    log(f"shards fleet: the {len(slow)} steps of longest readout latency, "
        f"with the actions logged before them and before the next step "
        f"(which syncs them): {slow}")
    try:
        n = rp.check_oracle(report, make, frame)
        check(n == report.n_steps, f"shards fleet digests == the "
              f"synchronous oracle's on a {n_shards}-shard factory, bitwise, at "
              f"all {n} deadlines")
    except AssertionError as err:
        check(False, f"shards fleet oracle gate: {err}")
    return dict(events_per_s=report.events_per_sec, launches=launches,
                launches_per_shard=per_shard, crossing=crossing,
                slowest_steps=slow,
                tiers={t: {k: report.tiers[t][k] for k in
                           ("ingested", "migrated", "latency_p50_us",
                            "latency_p99_us")} for t in report.tiers})


def latency_outliers(report, k=3):
    """The ``k`` steps of a replay with the longest readout latency, each
    with the kinds of the actions logged just before it and just before
    the next step (a pipelined step's latency runs until the next step
    syncs it)."""
    steps, acts, cur = [], [], {}
    for kind, e in report.log:
        if kind == "step":
            steps.append(e)
            acts.append(cur)
            cur = {}
        else:
            cur[kind] = cur.get(kind, 0) + 1
    acts.append(cur)
    order = sorted(range(len(steps)), key=lambda i: -steps[i].latency_s)
    return [dict(step=i, latency_ms=round(steps[i].latency_s * 1e3, 3),
                 n_events=steps[i].n_events, before=acts[i],
                 after=acts[i + 1]) for i in order[:k]]


def shard_migrate(dev, mods, words, card, devices=None):
    """Phase 8 (c): one migration between shards of a 4-shard QVGA pool
    (shards cycling over ``devices``, default ``dev``), bitwise the
    unsharded engine's ``migrate_slot``, timed."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.launch.mesh import make_host_mesh

    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    cfg = eng.TSEngineConfig(h=H, w=W, polarities=P,
                             n_slots=SHARD_MIGRATE_SLOTS, chunk_capacity=CAP,
                             mode="edram", specs=(frame,))
    mesh = make_host_mesh(SHARD_MIGRATE_SHARDS, devices=devices or [dev])
    sharded = eng.TimeSurfaceEngine(cfg, mesh=mesh)
    plain = eng.TimeSurfaceEngine(cfg, device=dev)
    src, dst = 1, SHARD_MIGRATE_SLOTS - 2
    sps = sharded._plan.slots_per_shard
    times = {}
    for e in (sharded, plain):
        for _ in range(SHARD_MIGRATE_SLOTS):
            e.attach()
        for b in range(2):
            e.serve_step([(s, words[s % N_SCENES][b])
                          for s in range(SHARD_MIGRATE_SLOTS)], frame,
                         DEADLINE_S)
        e._sessions[dst].detach()
        got, t_dev, t_host = timed_op(lambda: e.migrate(src, dst),
                                      mesh.devices)
        check(got == dst, f"shards: migrate {src} -> {dst} ({got})")
        times["sharded" if e is sharded else "plain"] = (t_dev, t_host)
    ok = all(b is None or same(a, b) for a, b in
             zip(eng._leaves(sharded.gather_state()),
                 eng._leaves(plain.state)))
    check(ok, f"shards: migrate {src} (shard {src // sps}) -> {dst} (shard "
          f"{dst // sps}) on {SHARD_MIGRATE_SHARDS} shards == the unsharded "
          f"migrate_slot, every leaf bitwise")
    after = sharded.serve_step([(dst, words[1][2])], frame, DEADLINE_S)
    want = plain.serve_step([(dst, words[1][2])], frame, DEADLINE_S)
    check(all(same(after[k], want[k]) for k in want),
          "shards: the next serve_step after the move == unsharded, bitwise")
    (sd, sh), (pd, ph) = times["sharded"], times["plain"]
    log(f"shards migrate on {card}: {P}x{H}x{W} slot {src} -> {dst} across "
        f"shards, device {sd:.4f} ms, host {sh:.4f} ms (the same move in "
        f"one unsharded pool: device {pd:.4f} ms, host {ph:.4f} ms)")
    return dict(cross_device_ms=sd, cross_host_ms=sh, plain_device_ms=pd,
                plain_host_ms=ph)


def shard_cli():
    """Phase 8 (d): the ``sensors --mesh 2`` CLI in a subprocess."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *SHARD_CLI_ARGV],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=SWEEP_TIMEOUT_S)
    for line in proc.stdout.splitlines():
        log(f"  sensors --mesh 2 | {line}")
    if proc.returncode:
        log(proc.stderr[-4000:])
    n = torch.cuda.device_count()
    placement = f"shard 0 -> cuda:0, shard 1 -> cuda:{1 % n}"
    check(proc.returncode == 0 and placement in proc.stdout
          and "fused surface bit-identical to dense readout: True"
          in proc.stdout,
          f"sensors --mesh 2 CLI on the card: exit {proc.returncode}, "
          f"placement {placement} printed, fused == dense "
          f"({time.perf_counter() - t0:.1f} s)")


def shard_loops(dev, mods, words, run, card):
    """Phase 8 (a), run straight after phase 1 while its products are
    held: the FRAME loop on 1, 2 and 4 shards of the card in turns (1, 2,
    4, 4, 2, 1), the first loop of each count profiled."""
    loops = {n: [] for n in SHARD_COUNTS}
    for n in SHARD_COUNTS + SHARD_COUNTS[::-1]:
        loops[n].append(shard_loop(dev, mods, words, run, n, card,
                                   profile=not loops[n]))
    return loops


def shard_phase(dev, mods, words, card, loops, fl, feeds):
    """Phase 8 (b)-(d) and the summary of (a)."""
    fleet = shard_fleet(dev, mods, card, feeds)
    log(f"shards fleet: events/s {fleet['events_per_s']:.1f} on 2 shards "
        f"(phase 7, one shard: {fl['events_per_s']:.1f})")
    mig = shard_migrate(dev, mods, words, card)
    shard_cli()
    for n, rs_ in loops.items():
        log(f"shards summary on {card}: {n} shard(s), in turns: events/s "
            f"{[round(r['events_per_s'], 1) for r in rs_]} (mean "
            f"{np.mean([r['events_per_s'] for r in rs_]):.1f}); serve_step "
            f"p50 {[round(r['p50_ms'], 3) for r in rs_]} ms, p99 "
            f"{[round(r['p99_ms'], 3) for r in rs_]} ms; route "
            f"{[round(r['route_ms_p50'], 4) for r in rs_]} ms")
    parts = {n: {k: float(np.mean([r["host_ms_per_step"][k] for r in rs_]))
                 for k in rs_[0]["host_ms_per_step"]}
             for n, rs_ in loops.items()}
    for n in SHARD_COUNTS[1:]:
        log(f"shards: host ms of a steady serve_step by part, {n} shards "
            f"less 1 shard (means of the loops in turns): "
            f"{ {k: round(parts[n][k] - parts[1][k], 4) for k in parts[1]} }")
    checked = loops[SHARD_LOOP_CHECKED][0]
    return dict(loops=loops, fleet=fleet, migrate=mig,
                launches=checked["launches"],
                launches_per_shard=checked["launches_per_shard"])


def visible_cards():
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def card_layouts(cards):
    """Phase 9's loops: (name, shard count, devices), each layout twice,
    forward then backward."""
    n = len(cards)
    one = [(f"{n} shards on 1 card", n, cards[:1]),
           (f"{n} shards on {n} cards", n, cards),
           ("2 shards on 2 cards", 2, cards[:2])]
    return one + one[::-1]


def card_loops(dev, mods, words, run, card):
    """Phase 9, part 1 (more than one card visible; run beside phase 8
    (a) while phase 1's products are held): one small copy between every
    ordered pair of cards (PyTorch enables peer access at a pair's first
    copy), one untimed N-card loop, then the layouts of ``card_layouts``
    in turns, every product bitwise phase 1's."""
    cards = visible_cards()
    t0 = time.perf_counter()
    for a in cards:
        for b in cards:
            if a != b:
                torch.ones(1, device=a).to(b)
    for d in cards:
        torch.cuda.synchronize(d)
    log(f"cards: first copies between every pair of the {len(cards)} "
        f"cards in {time.perf_counter() - t0:.3f} s")
    shard_loop(dev, mods, words, run, len(cards), card, devices=cards)
    log("cards: the first N-card loop above warmed every card; the loops "
        "below are timed in turns")
    runs = {}
    for name, n, devices in card_layouts(cards):
        runs.setdefault(name, []).append(shard_loop(
            dev, mods, words, run, n, card, devices=devices,
            profile=name not in runs))
    return runs


def cards_phase(dev, mods, words, card, runs, feeds, smi):
    """Phase 9, part 2: a migration from card 0's shard to the last
    card's, and the fleet on one shard per card, twice (the second on
    cards whose allocators the first warmed).  ``smi`` is every card's
    ``nvidia-smi`` name and power limit."""
    cards = visible_cards()
    log(f"cards: {smi}")
    for name, rr in runs.items():
        log(f"cards summary on {card}: {name}, in turns: events/s "
            f"{[round(r['events_per_s'], 1) for r in rr]} (mean "
            f"{np.mean([r['events_per_s'] for r in rr]):.1f}); "
            f"serve_step p50 {[round(r['p50_ms'], 3) for r in rr]} ms, "
            f"p99 {[round(r['p99_ms'], 3) for r in rr]} ms")
    mig = shard_migrate(dev, mods, words, card, devices=cards)
    fleets = [shard_fleet(dev, mods, card, feeds, n_shards=len(cards),
                          devices=cards) for _ in range(2)]
    for i, f in enumerate(fleets):
        log(f"cards fleet run {i + 1} on {len(cards)} cards: events/s "
            f"{f['events_per_s']:.1f}; p50/p99 per tier, us: "
            f"{ {t: (r['latency_p50_us'], r['latency_p99_us']) for t, r in f['tiers'].items()} }")
    return dict(cards=[str(d) for d in cards], smi=smi, migrate=mig,
                fleets=fleets,
                loops={name: [dict(events_per_s=r["events_per_s"],
                                   p50_ms=r["p50_ms"], p99_ms=r["p99_ms"],
                                   host_ms_per_step=r["host_ms_per_step"])
                              for r in rr] for name, rr in runs.items()})


def sweep_phase(card):
    """Phase 6, part 3: the ``sweep`` CLI in a subprocess on the card."""
    out = ROOT / "build" / "smoke_sweep"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "sweep",
         *SWEEP_ARGV, "--out", str(out)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True,
        text=True, timeout=SWEEP_TIMEOUT_S)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"  sweep | {line}")
    if proc.returncode:
        log(proc.stderr[-4000:])
        check(False, f"sweep CLI exited {proc.returncode}")
        return {}
    doc = json.loads((out / "sweep.json").read_text())
    v = doc["verdicts"]
    log(f"sweep on {card}: {len(doc['rows'])} runs in {secs:.1f} s")
    check(v["analog_3d_within_tol"] and v["analog_3d_energy_ok"]
          and v["analog_2d_worse_than_3d"],
          f"sweep verdicts: analog_3d within tolerance "
          f"{v['analog_3d_within_tol']}, energy >= 10x "
          f"{v['analog_3d_energy_ok']} (min "
          f"{v['analog_3d_energy_factor']:.0f}x), analog_2d worse "
          f"{v['analog_2d_worse_than_3d']}")
    return dict(verdicts=v, seconds=secs)


def grads_agree(loss, grads, cpu_loss, cpu_grads, what: str,
                cpu_again=None) -> float:
    """Check a card step's loss and gradients against the CPU port's in the
    CPU tests' band, and every gradient cell that is exactly 0 on the CPU
    0 on the card (Adam's normalised step makes a step of any nonzero);
    returns the largest error over each leaf's scale.  ``cpu_again``, the
    CPU's gradients once more at another thread count, narrows the exact
    zeros to those the CPU gives in both runs: a cell that is 0 in one
    order of summation and not in another is a cancellation, not a zero
    of the function (it is still held to the band)."""
    from repro_torch.models import module as M

    worst, broken, zeros = 0.0, 0, 0
    ok = abs(float(loss) - float(cpu_loss)) <= 1e-5 * abs(float(cpu_loss))
    want = M.flatten(cpu_grads)
    again = None if cpu_again is None else M.flatten(cpu_again)
    for k, g in M.flatten(grads).items():
        w, g = want[k].float(), g.float().cpu()
        err = (g - w).abs()
        tol = GRAD_TOL * w.abs() + GRAD_TOL * float(w.abs().max())
        ok &= bool((err <= tol).all())
        worst = max(worst, float(err.max()) / max(float(w.abs().max()), 1e-30))
        zero = w == 0
        if again is not None:
            moved = zero & (again[k] != 0)
            if moved.any():
                log(f"  {what}: {k}: {int(moved.sum())} cell(s) 0 in one "
                    f"CPU run and not in the other (a cancellation)")
            zero &= ~moved
        zeros += int(zero.sum())
        bad = zero & (g != 0)
        broken += int(bad.sum())
        for idx in bad.nonzero()[:4].tolist():
            log(f"  {what}: {k}{idx} is 0 on the CPU, "
                f"{float(g[tuple(idx)]):.3e} on the card (max|CPU leaf| "
                f"{float(w.abs().max()):.3e})")
    check(ok and not broken,
          f"{what}: loss {float(loss):.7f} (CPU {float(cpu_loss):.7f}) "
          f"and every gradient leaf within rtol {GRAD_TOL}, atol {GRAD_TOL} "
          f"x max|CPU leaf| (largest error {worst:.3e} of its leaf's max); "
          f"{broken} of the {zeros} cells exactly 0 on the CPU nonzero on "
          f"the card")
    return worst


def recon_small(dev) -> dict:
    """Phase 10 (a): the example's protocol at 48x48 on the card and on
    the CPU port (``RECON_CPU_THREADS`` threads), in this process."""
    from repro_torch.models import module as M
    from repro_torch.train import recon

    seen = []   # cuDNN's and cuBLAS's TF32 flags and cuDNN's enabled flag
    #             as autograd runs a backward

    def watched(params, xb, yb):
        out = recon.l1_loss(params, xb, yb)
        out.register_hook(lambda g: seen.append(
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.enabled)) or g)
        return out

    t0 = time.perf_counter()
    card = recon.run(80, dev, loss=watched,
                     log=lambda line: log(f"  recon 48x48 card | {line}"))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with recon.cpu_threads(RECON_CPU_THREADS):
        cpu = recon.run(80, "cpu")
    cpu_s = time.perf_counter() - t0
    log(f"recon 48x48: held-out SSIM card {card['ssim']:.4f}, CPU "
        f"{cpu['ssim']:.4f} after 80 steps ({card_s:.2f} s on the card, "
        f"{cpu_s:.2f} s on the CPU at {RECON_CPU_THREADS} threads)")
    check(len(seen) == 80 and not any(any(f) for f in seen)
          and torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.enabled,
          f"every backward of the card run ran with TF32 off in cuDNN and "
          f"cuBLAS and cuDNN off (direct convolutions; {len(seen)} "
          f"backwards), the global flags restored after")
    worst = grads_agree(card["losses"][0], card["first_grads"],
                        cpu["losses"][0], cpu["first_grads"],
                        "recon step 1, card vs CPU")
    # the same step at PyTorch's defaults (TF32 in the backward): what the
    # band above would catch
    pairs = recon.make_pairs(device=dev)
    params, _, _ = recon.init(80, 12, dev)
    idx = recon.batches(pairs.n_train, 1, BATCH)[0].to(dev)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in M.flatten(params).items()}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        loss = recon.l1_loss(M.unflatten(leaves), pairs.x[idx], pairs.y[idx])
        tf32 = dict(zip(leaves, torch.autograd.grad(loss,
                                                    list(leaves.values()))))
    want = M.flatten(cpu["first_grads"])
    tf32_err = max(float((g.cpu() - want[k]).abs().max())
                   / max(float(want[k].abs().max()), 1e-30)
                   for k, g in tf32.items())
    log(f"recon step 1 at PyTorch's defaults (TF32 in the backward): "
        f"largest gradient error {tf32_err:.3e} of its leaf's max (the "
        f"port's step: {worst:.3e})")
    members = {"card": [card["ssim"]] + recon_members(dev, pairs)}
    with recon.cpu_threads(RECON_CPU_THREADS):
        members["cpu"] = [cpu["ssim"]] + recon_members(
            torch.device("cpu"), recon.make_pairs(device="cpu"))
    med = {k: float(np.median(v)) for k, v in members.items()}
    log(f"recon 48x48: held-out SSIM of {RECON_MEMBERS} runs (the example, "
        f"then initial weights jittered by 1e-7): card "
        f"{[round(v, 4) for v in members['card']]}, median {med['card']:.4f}; "
        f"CPU at {RECON_CPU_THREADS} threads "
        f"{[round(v, 4) for v in members['cpu']]}, median {med['cpu']:.4f}")
    check(all(np.isfinite(card["losses"])) and np.isfinite(card["ssim"])
          and abs(med["card"] - med["cpu"]) <= RECON_SSIM_TOL,
          f"recon 48x48: every loss finite; held-out SSIM card vs CPU, "
          f"medians of {RECON_MEMBERS} runs, within {RECON_SSIM_TOL} "
          f"({abs(med['card'] - med['cpu']):.4f})")
    return dict(ssim_card=card["ssim"], ssim_cpu=cpu["ssim"],
                ssim_members=members, ssim_median=med,
                cpu_threads=RECON_CPU_THREADS,
                grad_err=worst, grad_err_pytorch_defaults=tf32_err,
                card_s=card_s, cpu_s=cpu_s)


def recon_members(dev, pairs) -> list:
    """The held-out SSIM of ``RECON_MEMBERS - 1`` more runs of the 48x48
    protocol on ``dev``, run m from ``recon.jitter``'s weights.  One run's
    SSIM is not a stable statistic: the protocol parts from any 1e-7
    perturbation, or another thread count, within ~6 steps, and ends near
    0.340 in most runs, near 0.323 or lower in the rest
    (``tools/train_probe.py spread``)."""
    from repro_torch.train import recon

    return [recon.run(80, dev, m=m, pairs=pairs)["ssim"]
            for m in range(1, RECON_MEMBERS)]


def recon_davis(dev, card) -> tuple:
    """Phase 10 (b): the protocol at DAVIS240C's sensor size.  Returns the
    report and the pairs (for (d))."""
    from repro_torch.train import recon

    h, w = DAVIS_HW
    t0 = time.perf_counter()
    pairs = recon.make_pairs(h, w, DAVIS_SCENES, DAVIS_DURATION, seed=9,
                          device=dev)
    torch.cuda.synchronize()
    n, n_tr = len(pairs.x), pairs.n_train
    log(f"recon {h}x{w} on {card}: {n} pairs ({n - n_tr} held out) built "
        f"in {time.perf_counter() - t0:.2f} s")
    params, opt, state = recon.init(DAVIS_STEPS, 12, dev)
    step = recon.make_step(opt)
    # warm-up steps on the initial weights, their results dropped
    p, st = params, state
    for i, idx in enumerate(recon.batches(n_tr, DAVIS_WARMUP, BATCH)):
        idx = idx.to(dev)
        p, st, _, _ = step(p, st, pairs.x[idx], pairs.y[idx], i)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)   # earlier phases' tensors
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    t_all = time.perf_counter()
    for i, idx in enumerate(recon.batches(n_tr, DAVIS_STEPS, BATCH)):
        t0 = time.perf_counter()
        idx = idx.to(dev)
        params, state, loss, _ = step(params, state, pairs.x[idx],
                                      pairs.y[idx], i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    wall = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated(dev) - base
    losses = torch.stack(losses).cpu()
    idx = recon.batches(n_tr, 1, BATCH)[0].to(dev)

    def two_steps():
        for i in range(2):
            step(params, state, pairs.x[idx], pairs.y[idx], DAVIS_STEPS + i)

    prof = profiled(two_steps)
    held = recon.held_out_ssim(params, pairs)
    r = dict(pairs=n, held_out=n - n_tr,
             step_ms_p50=float(np.percentile(step_ms, 50)),
             step_ms_p99=float(np.percentile(step_ms, 99)),
             pairs_per_s=BATCH * DAVIS_STEPS / wall,
             peak_gib=peak / 2**30, ssim=held,
             l1_first10=float(losses[:10].mean()),
             l1_last10=float(losses[-10:].mean()),
             device_idle=1 - prof["device_ms"] / prof["wall_ms"])
    log(f"recon {h}x{w} on {card}: UNet width 12, batch {BATCH}, "
        f"{DAVIS_STEPS} steps after {DAVIS_WARMUP} warm-up: step p50 "
        f"{r['step_ms_p50']:.3f} ms, p99 {r['step_ms_p99']:.3f} ms, "
        f"{r['pairs_per_s']:.1f} pairs/s, peak allocated by the run "
        f"{r['peak_gib']:.3f} GiB (above {base / 2**30:.3f} GiB held "
        f"before it), L1 {r['l1_first10']:.4f} (first 10) -> "
        f"{r['l1_last10']:.4f} (last 10), held-out SSIM {held:.4f}")
    profile_line(f"recon {h}x{w}, two training steps", prof)
    check(bool(torch.isfinite(losses).all()) and
          r["l1_last10"] < r["l1_first10"] and np.isfinite(held),
          f"recon {h}x{w}: every loss finite, mean L1 of the last 10 steps "
          f"below the first 10's, SSIM finite")
    return r, pairs


def cls_frames(dev):
    """The classification protocol's frames on ``dev``: ``streaming_ts``
    eDRAM reads of 50 ms windows through per-cell planes from
    ``PRNGKey(0)``, and the train split (the last stream of every three
    held out)."""
    from repro_torch.core import edram, prng
    from repro_torch.core import time_surface as ts
    from repro_torch.device import f32
    from repro_torch.events import datasets, pipeline

    streams = datasets.nmnist_like(n_classes=CLS_CLASSES, per_class=6,
                                   h=CLS_HW, w=CLS_HW, duration=0.25, seed=5)
    planes = edram.sample_variability(prng.PRNGKey(0, dev),
                                      (1, CLS_HW, CLS_HW),
                                      edram.decay_params_for_cmem())
    xs, ys, train = [], [], []
    for i, s in enumerate(streams):
        chunks = pipeline.window_chunks(s, CLS_WINDOW_S, 4096, device=dev)
        k = chunks.x.shape[0]
        reads = ((torch.arange(k, dtype=torch.float32, device=dev) + 1.0)
                 * f32(CLS_WINDOW_S, dev))
        fr = ts.streaming_ts(chunks, CLS_HW, CLS_HW, reads, tau=24e-3,
                             params=planes)[:, 0]
        xs.append(fr)
        ys += [s.label] * k
        train += [i % 3 != 2] * k
    x = torch.cat(xs)[..., None]
    keep = torch.tensor(train, device=dev)
    return x[keep], torch.tensor(ys, device=dev)[keep]


def cls_train(dev, profile: bool = False) -> dict:
    """The classification protocol's first ``CLS_STEPS`` AdamW steps, then
    (``profile``) two more under ``torch.profiler``."""
    from repro_torch.core import prng
    from repro_torch.models import module as M
    from repro_torch.models.cnn import cnn_apply, cnn_defs
    from repro_torch.train.grad import value_and_grad
    from repro_torch.train.optimizer import Schedule, adamw

    x, y = cls_frames(dev)
    params = M.init_params(cnn_defs(1, CLS_CLASSES, width=16),
                           prng.PRNGKey(7), dev)
    opt = adamw(Schedule(2e-3, warmup_steps=5, decay_steps=120))
    state = opt.init(params)
    loss_grad = value_and_grad(lambda p, xb, yb: torch.nn.functional
                               .cross_entropy(cnn_apply(p, xb), yb))
    rng = np.random.default_rng(0)
    losses, step_ms, first = [], [], None
    prof = None
    for i in range(CLS_STEPS):
        idx = torch.from_numpy(rng.choice(len(x), CLS_BATCH)).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = loss_grad(params, x[idx], y[idx])
        params, state = opt.update(grads, state, params, i)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if i == 0:
            first = (loss, grads)
    if profile:
        idx = torch.from_numpy(rng.choice(len(x), CLS_BATCH)).to(dev)

        def two_steps():
            for j in range(2):
                _, g = loss_grad(params, x[idx], y[idx])
                opt.update(g, state, params, CLS_STEPS + j)

        prof = profiled(two_steps)
    return dict(frames=len(x), losses=losses, step_ms=step_ms, first=first,
                prof=prof)


def cls_phase(dev, card) -> dict:
    """Phase 10 (c): the classification protocol's training step on the
    card and on the CPU port."""
    card_r = cls_train(dev, profile=True)
    cpu_r = cls_train(torch.device("cpu"))
    grads_agree(*card_r["first"], *cpu_r["first"],
                "classify step 1 (cross-entropy through cnn_apply), card vs "
                "CPU")
    ms = card_r["step_ms"][1:]
    log(f"classify on {card}: cnn width 16, {card_r['frames']} training "
        f"frames of {CLS_HW}x{CLS_HW}, batch {CLS_BATCH}: step p50 "
        f"{np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f} ms "
        f"(CPU p50 {np.percentile(cpu_r['step_ms'][1:], 50):.3f} ms); "
        f"loss {card_r['losses'][0]:.4f} -> {card_r['losses'][-1]:.4f}")
    profile_line(f"classify on {card}, two training steps", card_r["prof"],
                 step_ms=float(np.percentile(ms, 50)))
    check(all(np.isfinite(card_r["losses"])) and
          all(np.isfinite(cpu_r["losses"])),
          f"classify: every loss finite over {CLS_STEPS} steps, card and CPU")
    prof = card_r["prof"]
    return dict(frames=card_r["frames"], step_ms_p50=float(np.percentile(
        ms, 50)), cpu_step_ms_p50=float(np.percentile(
            cpu_r["step_ms"][1:], 50)), losses=card_r["losses"],
        device_ms_two_steps=prof["device_ms"],
        wall_ms_two_steps=prof["wall_ms"], launches_two_steps=prof["launches"],
        device_idle=1 - prof["device_ms"] / prof["wall_ms"])


def planes_phase(pairs) -> dict:
    """Phase 10 (d): ``ts_decay``'s (H, W) planes form on (b)'s SAEs."""
    from repro_torch.core import edram
    from repro_torch.core import time_surface as ts
    from repro_torch.kernels import _lib, ref

    planes = edram.DecayParams(*(p[0] for p in pairs.decay))
    n0 = _lib.LAUNCHES["ts_decay"]
    worst, n_reads = 0, 0
    for t in torch.unique(pairs.t_read):
        sel = pairs.t_read == t
        state = ts.SurfaceState(sae=pairs.sae[sel], t_last=None,
                                n_events=None)
        got = ts.surface_read_kernel(state, t, planes)
        want = ts.ts_edram(pairs.sae[sel], t, pairs.decay)
        worst = max(worst, int(ref.ulp_distance(got, want).max()))
        n_reads += 1
    torch.cuda.synchronize()
    launches = _lib.LAUNCHES["ts_decay"] - n0
    check(worst <= 2 and launches == n_reads,
          f"ts_decay planes form on the {len(pairs.sae)} SAEs of "
          f"{tuple(pairs.sae.shape[-2:])} ({n_reads} read times, {launches} "
          f"launches) within 2 ULP of ts_edram (max {worst} ULP)")
    return dict(max_ulp=worst, launches=launches)


def vision_phase(dev, card) -> dict:
    """Phase 10: the reconstruction and classification protocols trained
    on the card."""
    # PyTorch's default (cuDNN in TF32), which the kernel phases turned
    # off: the port's own float32 rule is what the checks below hold
    torch.backends.cudnn.allow_tf32 = True
    small = recon_small(dev)
    davis, pairs = recon_davis(dev, card)
    cls = cls_phase(dev, card)
    planes = planes_phase(pairs)
    return dict(recon_48=small, recon_davis=davis, classify=cls,
                planes=planes)


def train_full(dev, card) -> dict:
    """Phase 11 (a): mamba2-2.7b trained at full width and depth through
    the port's ``Trainer``."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.events.pipeline import TokenPipeline
    from repro_torch.kernels import _lib
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T
    from repro_torch.train import loop

    cfg = get_config(LM_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr = loop.Trainer(cfg, loop.TrainerConfig(), device=dev)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in M.flatten(tr.params).values())
    log(f"train on {card}: {LM_ARCH}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab} padded to {T.padded_vocab(cfg)}, "
        f"{cfg.activation_dtype}, remat {cfg.remat}, {cfg.n_microbatches} "
        f"microbatches, {cfg.optimizer}; {n_params} float32 parameters "
        f"from PRNGKey(0) and the optimizer state in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    check(cfg.remat and cfg.n_microbatches == 8 and cfg.optimizer == "adamw"
          and n_params > 2.8e9,
          f"the reference's training configuration: remat on, 8 "
          f"microbatches, AdamW, {n_params / 1e9:.3f} B parameters")
    pipe = TokenPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def one_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train(pipe, 1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    warm_ms = one_step()
    log(f"train: warm-up step {warm_ms:.1f} ms")
    _lib.reset_launches()
    step_ms = [one_step() for _ in range(TRAIN_TIMED_STEPS)]
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    med = statistics.median(step_ms)
    losses = [h["loss"] for h in tr.history]
    log(f"train on {card}: step ms {[round(v, 1) for v in step_ms]} -> "
        f"median {med:.1f} ms, {tokens * 1e3 / med:.1f} tokens/s "
        f"({TRAIN_BATCH} x {TRAIN_SEQ} tokens a step); peak allocated "
        f"{peak / 2**30:.2f} GiB; losses {[round(v, 4) for v in losses]}")
    per_step = {k: v / TRAIN_TIMED_STEPS for k, v in launches.items() if v}
    log(f"train: kernel launches a step on the path: {per_step}")
    want_fwd = 2 * cfg.n_layers * cfg.n_microbatches
    want_bwd = cfg.n_layers * cfg.n_microbatches
    check(launches["decay_scan"] == want_fwd * TRAIN_TIMED_STEPS
          and launches["decay_scan_bwd"] == want_bwd * TRAIN_TIMED_STEPS,
          f"decay_scan forward launched 2 x {cfg.n_layers} x "
          f"{cfg.n_microbatches} = {want_fwd} times a step (the forward and "
          f"its remat recompute) and the backward {want_bwd} times "
          f"({launches['decay_scan']}, {launches['decay_scan_bwd']} over "
          f"{TRAIN_TIMED_STEPS} steps)")
    ln_v = math.log(T.padded_vocab(cfg))
    check(all(math.isfinite(v) for v in losses)
          and abs(losses[0] - ln_v) <= 1.0,
          f"every loss finite; step 0's {losses[0]:.4f} within 1.0 of "
          f"ln {T.padded_vocab(cfg)} = {ln_v:.4f}")
    total = torch.cuda.get_device_properties(dev).total_memory
    check(peak < min(total, 80e9),
          f"peak allocated {peak / 1e9:.2f} GB under the card's "
          f"{total / 1e9:.2f} GB and 80 GB")
    t0 = time.perf_counter()
    prof = profiled_kernels(lambda: tr.train(pipe, 1))
    log(f"train: the profiled step and its trace took "
        f"{time.perf_counter() - t0:.1f} s")
    by_name = {}
    for k, v in prof["kernels"].items():
        by_name[k[:60]] = by_name.get(k[:60], 0.0) + v
    profile_line("train profile, one step", {**prof, "ops": by_name}, med)
    fwd_ms = sum(v for k, v in prof["kernels"].items()
                 if "decay_scan" in k and "bwd" not in k)
    bwd_ms = sum(v for k, v in prof["kernels"].items()
                 if "decay_scan_bwd" in k)
    dev_ms = max(prof["device_ms"], 1e-9)
    log(f"train: decay_scan forward {fwd_ms:.3f} ms "
        f"({100 * fwd_ms / dev_ms:.3f} %), backward "
        f"{bwd_ms:.3f} ms ({100 * bwd_ms / dev_ms:.3f} %) of "
        f"{prof['device_ms']:.1f} ms device time in one step")
    check(bwd_ms > 0, "torch.profiler traced the step's decay_scan_bwd "
          "kernels")
    del tr
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, median_ms=med,
                tokens_per_s=tokens * 1e3 / med, peak_gib=peak / 2**30,
                losses=losses, launches_per_step=per_step,
                decay_scan_fwd_share=fwd_ms / dev_ms,
                decay_scan_bwd_share=bwd_ms / dev_ms,
                device_idle=1 - prof["device_ms"] / prof["wall_ms"],
                launches=launches)


def train_check(dev) -> None:
    """Phase 11 (b): the full-width model at 2 layers in float32, one
    step's loss and gradients on the card against the CPU port."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.events.pipeline import TokenPipeline
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T
    from repro_torch.train import loop

    layers, batch, seq = TRAIN_CHECK
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=layers,
                              dtype="float32", n_microbatches=2)
    card = M.init_params(T.param_defs(cfg), prng.PRNGKey(1), dev)
    cpu = M.unflatten({k: v.cpu() for k, v in M.flatten(card).items()})
    tokens, labels = (torch.from_numpy(v) for v in
                      next(TokenPipeline(cfg.vocab, batch, seq, seed=1)))
    fn = loop.make_grad_fn(cfg)
    t0 = time.perf_counter()
    grads, met = fn(card, tokens.to(dev), labels.to(dev))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cgrads, cmet = fn(cpu, tokens, labels)
    t2 = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # the sums in their plain sequential order
    again, _ = fn(cpu, tokens, labels)
    torch.set_num_threads(threads)
    t3 = time.perf_counter()
    grads_agree(met["loss"], grads, cmet["loss"], cgrads,
                f"{LM_ARCH} full width, {layers} layers, float32, batch "
                f"{batch} x {seq} in 2 microbatches, one train step's "
                f"gradients (card {(t1 - t0) * 1e3:.0f} ms, CPU "
                f"{(t2 - t1) * 1e3:.0f} ms at {threads} threads; the exact "
                f"zeros those of a second CPU run at 1 thread, "
                f"{(t3 - t2) * 1e3:.0f} ms)", cpu_again=again)


def train_reduced(dev) -> dict:
    """Phase 11 (c): the trainer's contracts on the card at the reduced
    config: the loss falls, a save / restore resumes bitwise, both
    compressions step, and the CLI runs."""
    from repro_torch.configs import get_config
    from repro_torch.events.pipeline import TokenPipeline
    from repro_torch.models import module as M
    from repro_torch.train import loop

    cfg = get_config(LM_ARCH).reduced()
    batch, seq = TRAIN_REDUCED_BATCH
    tcfg = dict(lr=1e-3, decay_steps=100)

    def trainer(**kw):
        return loop.Trainer(cfg, loop.TrainerConfig(**tcfg, **kw), device=dev)

    tr = trainer()
    hist = tr.train(TokenPipeline(cfg.vocab, batch, seq, seed=0),
                    TRAIN_REDUCED_STEPS)["history"]
    losses = [h["loss"] for h in hist]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(last < first, f"reduced {LM_ARCH} on the card: mean loss of the "
          f"last 5 of {TRAIN_REDUCED_STEPS} steps {last:.4f} below the "
          f"first 5's {first:.4f}")
    ckdir = ROOT / "build" / "smoke_train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    straight = trainer()
    straight.train(TokenPipeline(cfg.vocab, batch, seq, seed=0), 4)
    first_half = trainer(ckpt_dir=str(ckdir), async_ckpt=False)
    pipe = TokenPipeline(cfg.vocab, batch, seq, seed=0)
    first_half.train(pipe, 2)
    first_half.save(pipe)
    resumed = trainer(ckpt_dir=str(ckdir))
    pipe2 = TokenPipeline(cfg.vocab, batch, seq, seed=7)
    restored = resumed.maybe_restore(pipe2)
    resumed.train(pipe2, 2)
    want = M.flatten((straight.params, straight.opt_state))
    got = M.flatten((resumed.params, resumed.opt_state))
    check(restored and resumed.step == 4 and set(got) == set(want)
          and all(same(got[k], want[k]) for k in want)
          and [h["loss"] for h in resumed.history]
          == [h["loss"] for h in straight.history[2:]],
          f"4 straight steps == 2 steps, save, a new Trainer's "
          f"maybe_restore, 2 steps: every parameter and moment bitwise "
          f"({len(want)} leaves), the losses equal")
    shutil.rmtree(ckdir, ignore_errors=True)
    comp = {}
    for kind in ("int8", "topk"):
        ctr = trainer(grad_compression=kind)
        comp[kind] = [h["loss"] for h in ctr.train(
            TokenPipeline(cfg.vocab, batch, seq, seed=0), 3)["history"]]
    check(all(np.isfinite(v).all() and len(v) == 3 for v in comp.values()),
          f"3 steps with --grad-compression int8 and topk, every loss "
          f"finite: {comp}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI_ARGV],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=300)
    tail = proc.stdout.strip().splitlines()[-3:]
    check(proc.returncode == 0 and "on cuda" in proc.stdout
          and "final step 3" in proc.stdout,
          f"python -m repro_torch.launch.train {' '.join(TRAIN_CLI_ARGV)} "
          f"on the card in {time.perf_counter() - t0:.1f} s: rc "
          f"{proc.returncode}, {tail} {proc.stderr[-400:] if proc.returncode else ''}")
    return dict(losses=losses, compressed=comp)


def train_phase(dev, card) -> dict:
    """Phase 11: the LM trainer on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    full = train_full(dev, card)
    t1 = time.perf_counter()
    train_check(dev)
    t2 = time.perf_counter()
    reduced = train_reduced(dev)
    log(f"train: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{time.perf_counter() - t2:.1f} s")
    return dict(full=full, reduced=reduced)


def close(a, b, tol):
    """max |a - b|, and whether a is within rtol = ``tol``, atol = ``tol``
    x max(1, max|b|) of b (sums of terms of b's size cancel near 0)."""
    a, b = a.float().cpu(), b.float().cpu()
    scale = max(1.0, float(b.abs().max()))
    return (float((a - b).abs().max()),
            bool(torch.allclose(a, b, rtol=tol, atol=tol * scale)))


def serve_lm(dev, card, cfg, what: str, profile=None) -> dict:
    """``cfg`` served through ``ServeEngine`` on the LM phase's traffic,
    its float32 weights drawn on the card from ``PRNGKey(0)``: a warm-up
    serve, the timed serve (counters zeroed just before, read just after,
    peak memory over it), then a prefill and two decode steps under
    ``torch.profiler`` (``profile``: ``profiled``, by PyTorch op, or
    ``profiled_kernels``, by kernel).  Checks one prefill and
    LM_NEW_TOKENS - 1 decode steps with every logit finite, and every
    token inside the true vocab."""
    from repro_torch.core import prng
    from repro_torch.kernels import _lib
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init_params(T.param_defs(cfg), prng.PRNGKey(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in M.flatten(params).values())
    engine = ServeEngine(cfg, params, max_len=LM_PROMPT[1] + LM_NEW_TOKENS)
    reqs = lm_requests(cfg, Request)
    calls, plain_prefill, plain_decode = timed_engine(engine)
    t0 = time.perf_counter()
    engine.serve([Request(r.prompt, max_new_tokens=2) for r in reqs])
    log(f"{what}: warm-up serve (same prompts, 2 tokens) "
        f"{time.perf_counter() - t0:.2f} s")
    calls.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(reqs)
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    s_max = max(len(r.prompt) for r in reqs)
    pf_s = [c[1] for c in calls if c[0] == "prefill"]
    dec_ms = [c[1] * 1e3 for c in calls if c[0] == "decode"]
    p50 = float(np.percentile(dec_ms, 50))
    log(f"{what} on {card}: {LM_REQUESTS} requests, prompts "
        f"{sorted(len(r.prompt) for r in reqs)} (left-padded to {s_max}), "
        f"{LM_NEW_TOKENS} new tokens each; serve {wall:.3f} s")
    log(f"{what} on {card}: prefill {pf_s[0] * 1e3:.3f} ms -> "
        f"{LM_REQUESTS * s_max / pf_s[0]:.1f} tokens/s computed; decode "
        f"step p50 {p50:.3f} ms, p99 {np.percentile(dec_ms, 99):.3f} ms over "
        f"{len(dec_ms)} steps of batch {LM_REQUESTS}; peak allocated "
        f"{peak:.2f} GiB")
    check(len(pf_s) == 1 and len(dec_ms) == LM_NEW_TOKENS - 1
          and all(c[3] for c in calls),
          f"{what}: one prefill and {LM_NEW_TOKENS - 1} decode steps, "
          f"every logit finite")
    toks = np.stack([r.tokens for r in results])
    check(toks.shape == (LM_REQUESTS, LM_NEW_TOKENS) and toks.min() >= 0
          and toks.max() < cfg.vocab,
          f"{what}: tokens {toks.shape} within the true vocab "
          f"[0, {cfg.vocab})")

    tokens = torch.zeros((LM_REQUESTS, s_max), dtype=torch.int32)
    for i, r in enumerate(reqs):
        tokens[i, s_max - len(r.prompt):] = torch.from_numpy(r.prompt)
    tokens = tokens.to(dev)
    with torch.inference_mode():
        profile = profile or profiled
        pf = profile(lambda: plain_prefill(params, tokens))
        _, caches, pos = plain_prefill(params, tokens)
        cur = tokens[:, -1:]
        dc = profile(lambda: [plain_decode(params, cur, caches, pos + i)
                              for i in range(2)])
    profile_line(f"{what} profile, one prefill", pf, pf_s[0] * 1e3)
    profile_line(f"{what} profile, two decode steps", dc, 2 * p50)
    del engine, caches
    return dict(layers=cfg.n_layers, params=n_params, init_s=init_s,
                prefill_ms=pf_s[0] * 1e3,
                prefill_tokens_per_s=LM_REQUESTS * s_max / pf_s[0],
                decode_ms=dec_ms, decode_p50_ms=p50, peak_gib=peak,
                launches=launches, calls=list(calls),
                prefill_device_idle=1 - pf["device_ms"] / pf["wall_ms"],
                decode_device_idle=1 - dc["device_ms"] / dc["wall_ms"],
                prefill_kernels=pf["launches"], decode_kernels=dc["launches"],
                prefill_profile=pf, tokens=tokens, model=params)


def dense_serve(dev, card, arch) -> dict:
    """Phase 12 (a), (b): ``arch`` served uncut through ``ServeEngine`` on
    the LM phase's traffic."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
    shape = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
             cfg.d_ff, cfg.vocab, T.padded_vocab(cfg), cfg.window,
             cfg.final_logit_softcap)
    check(shape == DENSE_WIDTHS[arch]
          and cfg.activation_dtype == torch.bfloat16
          and cfg.kv_cache_dtype == "bfloat16",
          f"{arch} at full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} query and {cfg.n_kv_heads} KV heads "
          f"of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} padded to "
          f"{T.padded_vocab(cfg)}, kinds {sorted(set(cfg.layer_kinds()))}, "
          f"window {cfg.window}, softcaps {cfg.attn_logit_softcap} / "
          f"{cfg.final_logit_softcap}, bf16 activations and KV cache")
    r = served(serve_lm(dev, card, cfg, f"dense {arch}"))
    # n_params() counts neither the vocab pad nor ln_f and the qk-norm gains
    extra = (2 * (T.padded_vocab(cfg) - cfg.vocab) * cfg.d_model
             + cfg.d_model + 2 * cfg.n_layers * cfg.head_dim * cfg.qk_norm)
    check(r["params"] == cfg.n_params() + extra,
          f"{arch}: {r['params']} float32 parameters "
          f"({r['params'] * 4 / 1e9:.2f} GB) drawn on the card from "
          f"PRNGKey(0) in {r['init_s']:.2f} s == n_params() "
          f"{cfg.n_params()} ({cfg.n_params() / 1e9:.2f} B) + {extra} (the "
          f"vocab pad, ln_f, the qk-norm gains)")
    check(not any(r["launches"].values()),
          f"dense {arch}: the path launched none of the port's CUDA kernels "
          f"(attention, the MLP and the KV rings run on PyTorch ops): "
          f"{r['launches']}")
    return r


def served(r: dict) -> dict:
    """``serve_lm``'s result without the model, its tokens and the
    per-call records, the card's memory released."""
    for k in ("model", "tokens", "calls", "prefill_profile"):
        r.pop(k)
    torch.cuda.empty_cache()
    return r


def true_fan_in_(lm, cfg) -> None:
    """Scale the attention projections of the LM params ``lm`` in place to
    their true fan-in (d_model; heads x head_dim for ``wo``), as the CPU
    tests draw them.  The reference's initialiser takes a 3-D leaf's
    last-but-one dim (the heads) as its fan-in, so at full widths the
    attention logits of a config without qk-norm or a softcap have a std
    of ~100-300 and the softmax is one-hot: a float32 rounding difference
    between two devices then picks another key in a few rows, and no band
    holds."""
    attn = lm["layers"]["attn"]
    for w, ref_fan, fan in (("wq", cfg.n_heads, cfg.d_model),
                            ("wk", cfg.n_kv_heads, cfg.d_model),
                            ("wv", cfg.n_kv_heads, cfg.d_model),
                            ("wo", cfg.head_dim, cfg.n_heads * cfg.head_dim)):
        attn[w].mul_((ref_fan / fan) ** 0.5)


def dense_check(dev, arch, layers, prompt=CHECK_PROMPT, reduced=False,
                batch=CHECK_BATCH, **kw) -> None:
    """Phase 12 (c) and 13 (c), one config: the full widths (``reduced()``
    ones with ``reduced``) at ``layers`` layers in float32 on the card
    against the CPU port on the same weights, ``batch`` rows of
    ``prompt`` tokens: a hybrid or expert config's ``forward`` logits and
    aux losses (z_loss within DENSE_TOL relative, lb_loss too when no
    routing differs), the prefill's last logits and caches (K/V rings, an
    SSM's conv rings and state), then DENSE_CHECK_DECODE decode steps'
    logits and the caches after them (int8 ones decode from empty caches:
    the reference's prefill builds unquantized ones).  With experts, each
    device's routing is recorded (``routes``): a batch row where a
    token's experts differ between the devices (a near tie) leaves the
    logits and caches compared from that call on, and more than
    ROUTE_FLIPS of the routed tokens fails."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T

    base = get_config(arch).reduced() if reduced else get_config(arch)
    cfg = dataclasses.replace(base, n_layers=layers, dtype="float32", **kw)
    card = M.init_params(T.param_defs(cfg), prng.PRNGKey(1), dev)
    true_fan_in_(card, cfg)
    cpu = M.unflatten({k: v.cpu() for k, v in M.flatten(card).items()})
    g = torch.Generator().manual_seed(2)
    n_dec = DENSE_CHECK_DECODE
    tokens = torch.randint(0, cfg.vocab, (batch, prompt + n_dec),
                           generator=g, dtype=torch.int32)
    max_len = prompt + n_dec
    int8 = cfg.kv_cache_dtype == "int8"
    what = (f"{arch} {'reduced' if reduced else 'full'} width, {layers} "
            f"layers, float32{', int8 KV cache' if int8 else ''}, batch "
            f"{batch} x {prompt}")
    errs = []
    keep = torch.ones(batch, dtype=torch.bool)
    flipped, routed = [], 0

    def both(on_card, on_cpu):
        """The same call on the card and on the CPU port; with experts,
        the batch rows whose routing differs drop out of ``keep``."""
        nonlocal routed
        with routes() as rg:
            out_g = on_card()
        with routes() as rc:
            out_c = on_cpu()
        for (ig, _), (ic, gap) in zip(rg, rc):
            flip = (ig != ic).any(-1)
            routed += flip.numel()
            if flip.any():
                rows = flip.view(batch, -1).any(-1)
                keep.mul_(~rows)
                flipped.append((int(flip.sum()), float(gap[flip].max())))
        return out_g, out_c

    def close_kept(a, b):
        """``close`` over the batch rows kept (none kept: nothing to
        compare; the routing check fails then)."""
        if not keep.any():
            return 0.0, True
        return close(a.cpu()[keep], b[keep], DENSE_TOL)

    def caches_agree(cg, cc):
        """(ok, max |d| of float leaves, int8 codes that differ by batch
        row) over the kept rows: positions bitwise, float K/V, conv rings
        and SSM states in the band, int8 codes within 1, bf16 scales
        within one bf16 ulp."""
        worst, flips, ok = 0.0, torch.zeros(batch, dtype=torch.long), True
        for a, b in zip(cg, cc):
            fb = M.flatten(b)
            for k, x in M.flatten(a).items():
                if not keep.any():
                    continue
                x, y = x.cpu()[keep], fb[k][keep]
                if k.endswith("pos"):
                    ok &= torch.equal(x, y)
                elif x.dtype == torch.int8:
                    d = (x.int() - y.int()).abs()
                    ok &= int(d.max()) <= 1
                    flips[keep] += (d != 0).flatten(1).sum(1)
                elif x.dtype == torch.bfloat16:
                    ok &= bool(((x.float() - y.float()).abs()
                                <= y.float().abs() * 2.0 ** -7).all())
                else:
                    e, good = close(x, y, DENSE_TOL)
                    worst, ok = max(worst, e), ok and good
        return ok, worst, flips

    def check_caches(cg, cc, when):
        ok, worst, _ = caches_agree(cg, cc)
        check(ok, f"{what}: caches {when} card == CPU port: positions "
              f"bitwise, float leaves within the band (max |d| {worst:.3e})")

    with torch.inference_mode():
        t0 = time.perf_counter()
        if cfg.family != "dense":
            n_flipped = len(flipped)
            (fg, ag), (fc, ac) = both(
                lambda: T.forward(card, tokens[:, :prompt].to(dev), cfg),
                lambda: T.forward(cpu, tokens[:, :prompt], cfg))
            errs.append(close_kept(fg, fc))
            del fg, fc
            if cfg.n_experts:
                rel = {k: abs(float(ag[k]) - float(ac[k])) / float(ac[k])
                       for k in ("lb_loss", "z_loss")}
                check(rel["z_loss"] <= DENSE_TOL and (
                          len(flipped) > n_flipped
                          or rel["lb_loss"] <= DENSE_TOL),
                      f"{what}: forward's lb_loss {float(ag['lb_loss']):.7f} "
                      f"(CPU {float(ac['lb_loss']):.7f}), z_loss "
                      f"{float(ag['z_loss']):.7f} (CPU "
                      f"{float(ac['z_loss']):.7f}) within {DENSE_TOL} "
                      f"relative ({rel}; lb_loss only when no routing "
                      f"differs)")
        if int8:
            cg = T.init_decode_caches(cfg, batch, max_len, device=dev)
            cc = T.init_decode_caches(cfg, batch, max_len,
                                      device="cpu")
            start = 0
        else:
            (lg, cg, start), (lc, cc, _) = both(
                lambda: T.prefill(card, tokens[:, :prompt].to(dev), cfg,
                                  max_len, last_logits_only=True),
                lambda: T.prefill(cpu, tokens[:, :prompt], cfg, max_len,
                                  last_logits_only=True))
            errs.append(close_kept(lg, lc))
            check_caches(cg, cc, f"after a prefill of {prompt} tokens")
        code_flips, codes_ok = [], True
        for i in range(n_dec):
            pos = start + i
            tok = tokens[:, pos:pos + 1]
            (lg, cg), (lc, cc) = both(
                lambda: T.decode_step(card, tok.to(dev), cg, pos, cfg),
                lambda: T.decode_step(cpu, tok, cc, pos, cfg))
            if int8:
                ok, _, flips = caches_agree(cg, cc)
                codes_ok &= ok
                code_flips.append(int(flips.sum()))
                # the card's codes carry over, so that a code one apart
                # moves only the step that wrote it
                for a, b in zip(cg, cc):
                    for k in a:
                        b[k].copy_(a[k])
                # a row whose codes differ gets the int8 band, the rest
                # DENSE_TOL
                rows = [close(lg[r], lc[r],
                              DENSE_INT8_TOL if flips[r] else DENSE_TOL)
                        for r in range(batch)]
                errs.append((max(e for e, _ in rows),
                             all(ok for _, ok in rows)))
            else:
                errs.append(close_kept(lg, lc))
        if int8:
            new = layers * 2 * batch * cfg.n_kv_heads * cfg.head_dim
            check(codes_ok and max(code_flips) <= new // 1000,
                  f"{what}: each step's int8 codes within 1 of the CPU's, "
                  f"one apart in at most 1 in 1000 of its {new} new cells "
                  f"(by step: {code_flips}), bf16 scales within one bf16 "
                  f"ulp, positions bitwise")
        else:
            check_caches(cg, cc, f"after {n_dec} decode steps")
    if cfg.n_experts:
        n_flip = sum(n for n, _ in flipped)
        check(n_flip <= ROUTE_FLIPS * routed and bool(keep.any()),
              f"{what}: expert choices equal on the card and the CPU for "
              f"{routed - n_flip} of {routed} routed tokens (flips, gap of "
              f"the k-th to the (k+1)-th router probability: {flipped}; "
              f"batch rows compared {keep.tolist()})")
    check(all(ok for _, ok in errs),
          f"{what}: {'' if cfg.family == 'dense' else 'forward logits, '}"
          f"{'' if int8 else f'the prefill last logits and '}"
          f"{n_dec} decode steps' logits card == CPU port within rtol = "
          f"{DENSE_TOL}, atol = {DENSE_TOL} x max(1, max|CPU|)"
          f"{f' ({DENSE_INT8_TOL} on a row whose codes differ in that step)' if int8 else ''}"
          f" (max |d| {[f'{e:.3e}' for e, _ in errs]}; "
          f"{time.perf_counter() - t0:.1f} s)")


@contextlib.contextmanager
def routes():
    """Record every ``moe.route`` call inside the block: its expert
    choices and, per token, the gap between the k-th and the (k+1)-th
    router probability (how near a tie the choice was), on the host."""
    from repro_torch.models import moe

    plain, seen = moe.route, []

    def recorded(router_w, x_flat, cfg):
        out = plain(router_w, x_flat, cfg)
        with torch.no_grad():
            p = torch.softmax(x_flat.float() @ router_w.float(), dim=-1)
            top = p.topk(min(cfg.top_k + 1, cfg.n_experts), dim=-1).values
            gap = (top[:, cfg.top_k - 1] - top[:, -1]
                   if cfg.top_k < cfg.n_experts else torch.ones_like(p[:, 0]))
        seen.append((out[0].cpu(), gap.cpu()))
        return out

    moe.route = recorded
    try:
        yield seen
    finally:
        moe.route = plain


def dense_train_check(dev, arch=DENSE_ARCH, layers=TRAIN_CHECK[0],
                      reduced=False) -> None:
    """Phase 12 (c) and 13 (c), the gradient check: ``arch``'s widths
    (``reduced()`` ones with ``reduced``) at ``layers`` layers in float32,
    one step's gradients (batch 2 x 300, 2 microbatches summed in
    float32) of ``loss_fn``'s total, its ``lb_loss`` and ``z_loss`` terms
    included, on the card against the CPU port, with phase 11 (b)'s
    exact-zero rule (a CPU run at 1 thread, whose sums run in another
    order, is taken only when a zero of the first CPU run is nonzero on
    the card: a cell that moves between the two is a cancellation); the
    aux losses within DENSE_TOL relative."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.events.pipeline import TokenPipeline
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T
    from repro_torch.train import loop

    _, batch, seq = TRAIN_CHECK
    base = get_config(arch).reduced() if reduced else get_config(arch)
    cfg = dataclasses.replace(base, n_layers=layers, dtype="float32",
                              n_microbatches=2, accum_dtype="float32")
    if arch == DENSE_ARCH:
        check(cfg.fsdp, f"{arch} trains with its config's fsdp=True and no "
              f"mesh (the reference ignores fsdp without one)")
    card = M.init_params(T.param_defs(cfg), prng.PRNGKey(1), dev)
    if not cfg.qk_norm:      # qk-norm bounds the attention logits itself
        true_fan_in_(card, cfg)
    cpu = M.unflatten({k: v.cpu() for k, v in M.flatten(card).items()})
    tokens, labels = (torch.from_numpy(v) for v in
                      next(TokenPipeline(cfg.vocab, batch, seq, seed=1)))
    fn = loop.make_grad_fn(cfg)
    t0 = time.perf_counter()
    grads, met = fn(card, tokens.to(dev), labels.to(dev))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cgrads, cmet = fn(cpu, tokens, labels)
    t2 = time.perf_counter()
    want = M.flatten(cgrads)
    moved = sum(int(((want[k] == 0) & (g.cpu() != 0)).sum())
                for k, g in M.flatten(grads).items())
    again = None
    if moved:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        again, _ = fn(cpu, tokens, labels)
        torch.set_num_threads(threads)
    t3 = time.perf_counter()
    what = (f"{arch} {'reduced' if reduced else 'full'} width, {layers} "
            f"layers, float32, batch {batch} x {seq} in 2 microbatches")
    grads_agree(met["loss"], grads, cmet["loss"], cgrads,
                f"{what}, one train step's gradients (card "
                f"{(t1 - t0) * 1e3:.0f} ms, CPU {(t2 - t1) * 1e3:.0f} ms; "
                f"{moved} zero(s) of the CPU run nonzero on the card"
                f"{f', rechecked at 1 thread in {t3 - t2:.1f} s' if moved else ''})",
                cpu_again=again)
    if cfg.n_experts:
        errs = {k: abs(float(met[k]) - float(cmet[k])) / float(cmet[k])
                for k in ("lb_loss", "z_loss")}
        check(all(e <= DENSE_TOL for e in errs.values()),
              f"{what}: the step's aux losses lb_loss {float(met['lb_loss']):.7f}"
              f" (CPU {float(cmet['lb_loss']):.7f}), z_loss "
              f"{float(met['z_loss']):.7f} (CPU {float(cmet['z_loss']):.7f}) "
              f"within {DENSE_TOL} relative ({errs})")


def event_lm_phase(dev, card) -> dict:
    """Phase 12 (d): the event-LM example's protocol on the card and on
    the CPU port from the same seed."""
    from repro_torch.train import event_lm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = event_lm.run(EVENT_LM_STEPS, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = event_lm.run(EVENT_LM_STEPS, "cpu")
    cpu_s = time.perf_counter() - t0
    curve = [round(v, 4) for v in on_card["losses"]]
    log(f"event-LM on {card}: {EVENT_LM_STEPS} steps, "
        f"{1e3 * on_card['s_per_step']:.2f} ms per step "
        f"({card_s:.2f} s with the data and weights; CPU port "
        f"{1e3 * on_cpu['s_per_step']:.2f} ms per step, {cpu_s:.2f} s); "
        f"losses {curve}")
    log(f"event-LM: held-out accuracy {on_card['accuracy']:.2f} on the card, "
        f"{on_cpu['accuracy']:.2f} on the CPU port (the reference's split "
        f"holds out the first fifth of the streams: 5 of class 0, which no "
        f"training batch holds, and 1 of class 1)")
    e0 = abs(on_card["losses"][0] - on_cpu["losses"][0])
    check(np.isfinite(on_card["losses"]).all()
          and e0 <= 1e-5 * abs(on_cpu["losses"][0]),
          f"event-LM: every loss finite; step 0's {on_card['losses'][0]:.7f} "
          f"within 1e-5 relative of the CPU port's "
          f"{on_cpu['losses'][0]:.7f}")
    event_lm_grads(dev)
    return dict(losses=on_card["losses"], cpu_losses=on_cpu["losses"],
                accuracy=on_card["accuracy"], cpu_accuracy=on_cpu["accuracy"],
                ms_per_step=1e3 * on_card["s_per_step"])


def event_lm_grads(dev) -> None:
    """Phase 12 (d), the gradient check: step 0's batch at the example's
    weights, the attention projections at their true fan-in
    (``true_fan_in_``; at the example's own weights the reference's
    gradients move by more than the band when the weights move by half an
    ulp: ``tests/test_torch_event_lm.py``), card against the CPU port
    with phase 11 (b)'s exact-zero rule."""
    from repro_torch.models import module as M
    from repro_torch.train import event_lm
    from repro_torch.train.grad import value_and_grad

    classes, batch = 6, 8          # the example's defaults, as run() has them
    cfg = event_lm.config(classes=classes)
    grad_fn = value_and_grad(
        lambda p, x, y: event_lm.apply(p, x, y, cfg, classes), has_aux=True)

    def step0(device):
        params = event_lm.init(cfg, device)
        true_fan_in_(params["lm"], cfg)
        saes, labels, n_test = event_lm.dataset(classes, device)
        sel = torch.from_numpy(np.random.default_rng(0).choice(
            np.arange(n_test, len(labels)), batch)).to(device)
        (loss, _), grads = grad_fn(params, saes[sel], labels[sel])
        return float(loss), grads

    t0 = time.perf_counter()
    loss, grads = step0(dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu_loss, cpu_grads = step0("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # the sums in their plain sequential order
    _, again = step0("cpu")
    torch.set_num_threads(threads)
    t2 = time.perf_counter()
    check(any(k.startswith("frontend.") for k in M.flatten(grads)),
          "event-LM: the gradients reach the event frontend")
    grads_agree(loss, grads, cpu_loss, cpu_grads,
                f"event-LM step 0's batch, attention projections at their "
                f"true fan-in: loss and gradients through the decoder, the "
                f"embeds and the event frontend (card {(t1 - t0) * 1e3:.0f} "
                f"ms, CPU at {threads} and at 1 thread {(t2 - t1) * 1e3:.0f} "
                f"ms)", cpu_again=again)


def dense_phase(dev, card) -> dict:
    """Phase 12: the dense LM family on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    times, served = {}, {}
    for arch in DENSE_SERVE:
        t0 = time.perf_counter()
        served[arch] = dense_serve(dev, card, arch)
        times[arch] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for arch, layers in DENSE_CHECK:
        dense_check(dev, arch, layers)
    dense_check(dev, DENSE_ARCH, 2, kv_cache_dtype="int8")
    times["checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense_train_check(dev)
    times["train check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = event_lm_phase(dev, card)
    times["event_lm"] = time.perf_counter() - t0
    log(f"dense: phase 12 seconds by part "
        f"{ {k: round(v, 1) for k, v in times.items()} }")
    return dict(served=served, event_lm=ev, seconds=times)


def hybrid_serve(dev, card) -> dict:
    """Phase 13 (a): hymba-1.5b served uncut through ``ServeEngine`` on
    the LM phase's traffic: its SSD heads reach ``decay_scan`` once a
    layer per prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T

    cfg = get_config(HYBRID_ARCH)
    wins = T.layer_windows(cfg)
    shape = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
             cfg.d_ff, cfg.vocab, T.padded_vocab(cfg), cfg.window,
             tuple(i for i, w in enumerate(wins) if w is None),
             SSM.ssm_dims(cfg))
    check(shape == HYBRID_WIDTHS and cfg.n_layers == 32
          and cfg.activation_dtype == torch.bfloat16,
          f"{HYBRID_ARCH} uncut: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} query and {cfg.n_kv_heads} KV heads "
          f"of {cfg.head_dim} beside SSD (d_inner, heads, headdim, state) "
          f"{SSM.ssm_dims(cfg)} in every layer, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab} padded to {T.padded_vocab(cfg)}, global layers "
          f"{shape[8]}, the others a window of {cfg.window}, bf16")
    # by kernel: with the host's activity, the per-op tables of a prefill
    # and two decode steps (~35,000 launches) took most of the ~44 s this
    # part took on an H100
    r = serve_lm(dev, card, cfg, f"hybrid {HYBRID_ARCH}",
                 profile=profiled_kernels)
    # n_params() counts neither the vocab pad, ln_f nor the branch norms
    extra = (2 * (T.padded_vocab(cfg) - cfg.vocab) * cfg.d_model
             + cfg.d_model + 2 * cfg.n_layers * cfg.d_model)
    check(r["params"] == cfg.n_params() + extra,
          f"{HYBRID_ARCH}: {r['params']} float32 parameters "
          f"({r['params'] * 4 / 1e9:.2f} GB) drawn on the card from "
          f"PRNGKey(0) in {r['init_s']:.2f} s == n_params() "
          f"{cfg.n_params()} + {extra} (the vocab pad, ln_f, the two "
          f"branch norms a layer)")
    per = [c[2] for c in r["calls"] if c[0] == "prefill"]
    dec = [c[2] for c in r["calls"] if c[0] == "decode"]
    check(per == [cfg.n_layers] and r["launches"]["decay_scan"] == cfg.n_layers
          and not any(dec),
          f"hybrid {HYBRID_ARCH}: decay_scan launched n_layers = "
          f"{cfg.n_layers} times by the one prefill ({per}) and never by "
          f"the {len(dec)} decode steps; launches on the path "
          f"{r['launches']}")
    pf = r["prefill_profile"]
    scan_ms = sum(v for k, v in pf["kernels"].items() if "decay_scan" in k)
    check(scan_ms > 0, "torch.profiler traced the hybrid prefill's "
          "decay_scan kernels")
    log(f"hybrid {HYBRID_ARCH}: decay_scan kernels inside one prefill: "
        f"{scan_ms:.3f} ms of {pf['device_ms']:.3f} ms device time "
        f"({100 * scan_ms / pf['device_ms']:.2f} %; "
        f"{100 * scan_ms / r['prefill_ms']:.2f} % of the "
        f"{r['prefill_ms']:.3f} ms prefill); "
        f"{r['decode_kernels'] / 2:.0f} kernel launches per decode step")
    s_max = r["tokens"].shape[1]
    _, h, p, n = SSM.ssm_dims(cfg)
    out = served(r)
    out.update(decay_scan_ms=scan_ms,
               scan_shape=(LM_REQUESTS, -(-s_max // cfg.ssm_chunk), h * p * n))
    return out


def moe_serve(dev, card) -> dict:
    """Phase 13 (b): grok-1-314b at its full widths and MOE_LAYERS layers
    served through ``ServeEngine`` on the LM phase's traffic; then the
    tokens each expert took in one more prefill, and the aux losses of
    one ``forward``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    shape = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
             cfg.n_experts, cfg.top_k, cfg.d_ff_expert, cfg.vocab,
             T.padded_vocab(cfg))
    check(shape == MOE_WIDTHS and cfg.activation_dtype == torch.bfloat16,
          f"{MOE_ARCH} at full widths, {cfg.n_layers} of 64 layers: d_model "
          f"{cfg.d_model}, {cfg.n_heads} query and {cfg.n_kv_heads} KV heads "
          f"of {cfg.head_dim}, {cfg.n_experts} experts top-{cfg.top_k} of "
          f"d_ff {cfg.d_ff_expert}, vocab {cfg.vocab}, bf16")
    r = serve_lm(dev, card, cfg, f"moe {MOE_ARCH}")
    check(r["params"] == cfg.n_params() + cfg.d_model,
          f"{MOE_ARCH}: {r['params']} float32 parameters "
          f"({r['params'] * 4 / 1e9:.2f} GB) drawn on the card from "
          f"PRNGKey(0) in {r['init_s']:.2f} s == n_params() + ln_f")
    check(r["peak_gib"] * 2**30 < torch.cuda.get_device_properties(dev)
          .total_memory and not any(r["launches"].values()),
          f"moe {MOE_ARCH}: peak {r['peak_gib']:.2f} GiB within the card's "
          f"memory; the path launched none of the port's CUDA kernels "
          f"({r['launches']})")
    params, tokens = r["model"], r["tokens"]
    with torch.inference_mode(), routes() as seen:
        T.prefill(params, tokens, cfg, tokens.shape[1],
                  last_logits_only=True)
    per_expert = [torch.bincount(idx.flatten(), minlength=cfg.n_experts)
                  .tolist() for idx, _ in seen]
    log(f"moe {MOE_ARCH}: tokens per expert in one prefill of "
        f"{tokens.numel()} tokens (top-{cfg.top_k}), by layer: {per_expert}")
    b, sq = MOE_AUX_SEQ
    with torch.inference_mode():
        logits, aux = T.forward(params, tokens[:b, -sq:], cfg)
    aux = {k: float(v) for k, v in aux.items()}
    check(bool(torch.isfinite(logits).all()) and all(
        np.isfinite(v) and v > 0 for v in aux.values()),
          f"moe {MOE_ARCH}: one forward of {b} x {sq} tokens: logits finite, "
          f"lb_loss {aux['lb_loss']:.6f} (1.0 at a perfect balance), z_loss "
          f"{aux['z_loss']:.6f}")
    del logits
    out = served(r)
    out.update(tokens_per_expert=per_expert, aux=aux)
    return out


def hybrid_phase(dev, card) -> dict:
    """Phase 13: the hybrid and MoE families on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    times = {}
    t0 = time.perf_counter()
    hy = hybrid_serve(dev, card)
    times["hybrid serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mo = moe_serve(dev, card)
    times["moe serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense_check(dev, HYBRID_ARCH, HYBRID_CHECK[0], prompt=HYBRID_CHECK[1])
    layers, batch, seq = MOE_CHECK
    dense_check(dev, MOE_ARCH, layers, prompt=seq, batch=batch)
    dense_check(dev, "kimi-k2-1t-a32b", 2, reduced=True)
    times["checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense_train_check(dev, HYBRID_ARCH, HYBRID_CHECK[0])
    dense_train_check(dev, "kimi-k2-1t-a32b", 2, reduced=True)
    times["train checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b, t, c = hy["scan_shape"]
    scan = scan_forward(dev, b, t, c)
    n = hy["launches"]["decay_scan"]
    log(f"decay_scan at {HYBRID_ARCH}'s prefill shape ({b}, {t}, {c}): "
        f"{scan['ms']:.4f} ms, plain {scan['plain_ms']:.4f} ms, bound "
        f"{scan['bound_ms']:.4f} ms ({scan.pop('nbytes')} B, "
        f"{scan['bound_by']}; {100 * scan['bound_ms'] / scan['ms']:.1f} % of "
        f"it); x {n} launches = {scan['ms'] * n:.3f} ms of a "
        f"{hy['prefill_ms']:.3f} ms prefill")
    times["decay_scan"] = time.perf_counter() - t0
    log(f"hybrid and moe: phase 13 seconds by part "
        f"{ {k: round(v, 1) for k, v in times.items()} }")
    return dict(hybrid=hy, moe=mo, decay_scan=scan, seconds=times)


def example_main(name: str):
    """The ``main`` of ``examples/<name>`` (not run)."""
    return runpy.run_path(str(ROOT / "examples" / name))["main"]


def run_example(name: str, argv=()):
    """(what the example's ``main`` returned, its printed lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = example_main(name)(list(argv))
    return out, buf.getvalue().splitlines()


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    from repro_torch.kernels import ref

    return int(ref.ulp_distance(a.cpu(), b.cpu()).max())


def counted(_lib, fn):
    """(``fn()``, the launches of each time-surface kernel it made)."""
    before = dict(_lib.LAUNCHES)
    out = fn()
    return out, {k: _lib.LAUNCHES[k] - before[k] for k in ENGINE_KERNELS}


def examples_phase(_lib) -> dict:
    """Phase 14 (a): the three torch examples on the card, then on the CPU
    port, in this process; ``serve_sensors`` once more on 2 shards."""
    secs = {}
    torch.cuda.synchronize()
    _lib.reset_launches()
    gpu = {}
    for name in EXAMPLE_FILES:
        t0 = time.perf_counter()
        gpu[name], lines = run_example(name)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        for line in lines:
            log(f"  {name[:-9]} | {line}")
    launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    log(f"examples: kernel launches of the three card runs: {launches}")
    for k in ("ts_decay", "stcf_support", "chunk_scatter"):
        check(launches[k] > 0,
              f"{k} launched on the examples' path ({launches[k]})")
    host = {}
    for name in EXAMPLE_FILES:
        t0 = time.perf_counter()
        host[name], _ = run_example(name, ("--device", "cpu"))
        secs[f"{name} cpu"] = time.perf_counter() - t0

    qg, qc = gpu[EXAMPLE_FILES[0]], host[EXAMPLE_FILES[0]]
    check(same(qg["support"], qc["support"])
          and same(qg["support_i"], qc["support_i"]),
          f"quickstart: STCF supports (analog and ideal TS, "
          f"{qg['support'].numel()} events) card == CPU port, bitwise")
    check(abs(qg["auc"] - qc["auc"]) <= AUC_TOL
          and abs(qg["auc_i"] - qc["auc_i"]) <= AUC_TOL,
          f"quickstart: AUCs card vs CPU port within {AUC_TOL} (analog "
          f"{qg['auc']!r} / {qc['auc']!r}, ideal {qg['auc_i']!r} / "
          f"{qc['auc_i']!r})")
    u = ulps(qg["surface"], qc["surface"])
    check(u <= QVGA_ULP, f"quickstart: analog surface card vs CPU port "
          f"within {QVGA_ULP} ULP ({u})")
    dg, dc = gpu[EXAMPLE_FILES[1]], host[EXAMPLE_FILES[1]]
    for mode, m in dg["masks"].items():
        check(same(m, dc["masks"][mode]),
              f"denoise: mode {mode}'s window masks {tuple(m.shape)} card "
              f"== CPU port, bitwise")
    check(same(dg["support"], dc["support"])
          and abs(dg["auc"] - dc["auc"]) <= AUC_TOL,
          f"denoise: streaming support card == CPU port, bitwise, AUC "
          f"within {AUC_TOL} ({dg['auc']!r} / {dc['auc']!r})")
    sg, sc = gpu[EXAMPLE_FILES[2]], host[EXAMPLE_FILES[2]]
    for key in ("occupancy", "active", "n_events", "counters"):
        check(sg[key] == sc[key], f"serve_sensors: {key} card == CPU port")
    err, ok = close(sg["logits"], sc["logits"], 1e-5)
    check(ok, f"serve_sensors: logits card vs CPU port within rtol 1e-5 "
          f"(max |diff| {err:.3g})")
    log(f"serve_sensors: replay counters {sg['counters']}")

    t0 = time.perf_counter()
    two, lines = run_example(EXAMPLE_FILES[2], ("--mesh", "2"))
    torch.cuda.synchronize()
    secs["serve_sensors_torch.py --mesh 2"] = time.perf_counter() - t0
    log(f"  serve_sensors --mesh 2 | {lines[0]}")
    for key in ("occupancy", "active", "n_events", "keep", "counters"):
        check(two[key] == sg[key],
              f"serve_sensors --mesh 2: {key} == the unsharded card run's")
    differ = [f"{part}.{n}" for part in ("frame", "model")
              for n, v in sg[part].items()
              if not same(two[part][n][:v.shape[0]], v)]
    check(not differ and same(two["logits"], sg["logits"]),
          f"serve_sensors --mesh 2: window and model products == the "
          f"unsharded card run's, bitwise (differ: {differ})")
    log(f"examples: seconds {({k: round(v, 2) for k, v in secs.items()})}")
    return dict(launches=launches, seconds=secs,
                quickstart_auc=(qg["auc"], qg["auc_i"]),
                denoise_auc=dg["auc"], surface_ulp=u)


def qvga_engine_cfg(eng, rs, cfg):
    """The serve_sensors FRAME spec and an engine config at ``cfg``'s
    widths (the paper's ``ISCConfig``), four sensors."""
    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           count=rs.count(4))
    return frame, eng.TSEngineConfig(
        h=cfg.h, w=cfg.w, polarities=cfg.polarities,
        n_slots=len(QVGA_SCENES), chunk_capacity=QVGA_CHUNK,
        cmem_f=cfg.cmem_f, tau_tw=cfg.tau_tw, stcf_radius=cfg.stcf_radius,
        stcf_threshold=cfg.stcf_threshold, mode="edram", specs=(frame,))


def near_v_tw(v, v_tw, radius=None):
    """Cells whose read is within 4 ULP of V_tw (with ``radius``: cells
    whose STCF patch holds one)."""
    from repro_torch.kernels import ref

    near = ref.ulp_distance(v.cpu(), torch.full(v.shape, v_tw)) <= 4
    if radius is None:
        return near
    return ref.stcf_support_ref(near, radius, include_self=True) > 0


def equal_or_near(what, a, b, near) -> None:
    """Check two comparator products bitwise, saying how many cells
    differ and whether every one of them sits next to V_tw."""
    diff = a.cpu() != b.cpu()
    n = int(diff.sum())
    check(n == 0, f"{what} card == CPU port, bitwise ({n} of {diff.numel()}"
          f" cells differ{'' if not n else ', all next to V_tw: '}"
          f"{'' if not n else bool((diff <= near).all())})")


def qvga_shims(_lib, aer, rs, eng, ecfg, bursts) -> dict:
    """Phase 14 (b), part 2: the FRAME loop's bursts through the
    deprecated shims on one card engine and the session/spec path on a
    twin, window by window: every output bitwise, the same launches."""
    from repro_torch.events import datasets

    n_win = len(bursts) // 2
    t_end = n_win * QVGA_WINDOW_S
    shim, twin = eng.TimeSurfaceEngine(ecfg), eng.TimeSurfaceEngine(ecfg)
    mask_spec, stcf_spec = shim_specs(rs)
    slots = [shim.acquire() for _ in QVGA_SCENES]
    cams = [twin.attach() for _ in QVGA_SCENES]
    per_step, mismatched, shim_n = {"shims": [], "spec": []}, [], {}
    for w in range(n_win):
        t_now = (w + 1) * QVGA_WINDOW_S
        b1, b2 = bursts[2 * w], bursts[2 * w + 1]

        def shim_step():
            shim.ingest(list(zip(slots, b1)))
            v = shim.ingest_and_read(list(zip(slots, b2)), t_now)
            return [v, *shim.readout_with_mask(t_now),
                    shim.support_map(t_now)]

        def spec_step():
            twin.push(list(zip(cams, b1)))
            v = twin.serve_step(list(zip(cams, b2)), rs.SURFACE_SPEC,
                                t_now)["surface"]
            both = twin.read(mask_spec, t_now)
            return [v, both["surface"], both["mask"],
                    twin.read(stcf_spec, t_now)["stcf"]]

        got, n_shim = counted(_lib, shim_step)
        want, n_spec = counted(_lib, spec_step)
        per_step["shims"].append(n_shim)
        per_step["spec"].append(n_spec)
        if not all(same(a, b) for a, b in zip(got, want)):
            mismatched.append(w)
    last = [shim.readout(t_end), *shim.readout_with_mask(t_end),
            shim.support_map(t_end)]
    shim_sae = shim.state.surfaces.sae.clone()
    label = aer.pack(datasets.dnd21_like(
        "hotel_bar", ecfg.h, ecfg.w, QVGA_DURATION,
        seed=QVGA_LABEL_SEED).window(t_end - QVGA_WINDOW_S, t_end))
    (sup, sig), n_label = counted(_lib, lambda: shim.ingest(
        [(slots[1], label)], with_support=True)[0])
    sup_t, sig_t = cams[1].push_labeled(label)
    shim.release(slots[1])
    cams[1].detach()
    after = (shim.readout(t_end), twin.read(rs.SURFACE_SPEC, t_end)["surface"])
    for k in ENGINE_KERNELS:
        shim_n[k] = (sum(n[k] for n in per_step["shims"]) + n_label[k])
    log(f"isc-qvga: launches a window under the shims {per_step['shims']}; "
        f"under the session/spec path {per_step['spec']}; the labeled "
        f"push {n_label}")
    check(per_step["shims"] == per_step["spec"],
          "isc-qvga: the shims launch what the session/spec path launches, "
          "window by window")
    for k in ("ts_decay", "stcf_support", "chunk_scatter"):
        check(shim_n[k] > 0, f"isc-qvga: {k} launched under the shims "
              f"({shim_n[k]})")
    check(not mismatched and same(sup, sup_t) and same(sig, sig_t)
          and same(*after),
          f"isc-qvga: every shim output == its session/spec twin's, "
          f"bitwise: ingest_and_read, readout_with_mask, support_map at "
          f"{n_win} windows (mismatched: {mismatched}), "
          f"ingest(with_support=True) ({sup.numel()} labels), readout "
          f"after release")
    return dict(shim_launches=shim_n, shim_sae=shim_sae, last=last,
                launches_per_window={k: [sum(n.values()) for n in v]
                                     for k, v in per_step.items()})


def shim_specs(rs):
    """The specs the ``readout_with_mask`` and ``support_map`` shims read."""
    return (rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask()),
            rs.ReadoutSpec(stcf=rs.stcf()))


def qvga_serve(dev, mods, cfg, bursts, card) -> dict:
    """Phase 14 (b), part 1: the four-scene mix at the array's widths
    through ``serve_step`` with the FRAME spec (timed), then the shims
    and their twin (``qvga_shims``), on the card; then a CPU engine's
    FRAME loop on the same events."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    frame, ecfg = qvga_engine_cfg(eng, rs, cfg)
    n_win = len(bursts) // 2
    t_end = n_win * QVGA_WINDOW_S

    def frame_loop(engine):
        cams = [engine.attach() for _ in QVGA_SCENES]
        outs, step_ms = [], []
        for b, words in enumerate(bursts):
            t_now = (b // 2 + 1) * QVGA_WINDOW_S
            t0 = time.perf_counter()
            out = engine.serve_step(list(zip(cams, words)), frame, t_now)
            if engine.device.type == "cuda":
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if b % 2:
                outs.append({k: v.cpu() for k, v in out.items()})
        return outs, step_ms

    torch.cuda.synchronize()
    _lib.reset_launches()
    engine = eng.TimeSurfaceEngine(ecfg)
    outs, step_ms = frame_loop(engine)
    frame_launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    n_events = int(engine.state.surfaces.n_events.sum())
    steady = step_ms[2:]          # the first window pays first-touch costs
    p50, p99 = np.percentile(steady, 50), np.percentile(steady, 99)
    log(f"isc-qvga on {card}: {len(QVGA_SCENES)} sensors x {ecfg.h}x"
        f"{ecfg.w}, {n_win} windows x 2 bursts, {n_events} events; "
        f"serve_step (FRAME: surface, mask, count) over windows 2..{n_win}: "
        f"p50 {p50:.3f} ms, p99 {p99:.3f} ms (dense fill p50 "
        f"{np.percentile(steady[0::2], 50):.3f} ms, incremental p50 "
        f"{np.percentile(steady[1::2], 50):.3f} ms); every step, ms: "
        f"{[round(x, 3) for x in step_ms]}")
    log(f"isc-qvga: FRAME loop launches {frame_launches}")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        shims = qvga_shims(_lib, aer, rs, eng, ecfg, bursts)
    launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}

    # the CPU port: the FRAME loop on the same events
    t0 = time.perf_counter()
    host = eng.TimeSurfaceEngine(ecfg, device="cpu")
    host_outs, _ = frame_loop(host)
    cpu_s = time.perf_counter() - t0
    g, c = engine.state, host.state
    for name, a, b in (("sae", g.surfaces.sae, c.surfaces.sae),
                       ("shim engine's sae", shims["shim_sae"],
                        c.surfaces.sae),
                       ("counts", g.counts, c.counts),
                       ("n_events", g.surfaces.n_events, c.surfaces.n_events)):
        check(same(a, b), f"isc-qvga: {name} card == CPU port, bitwise")
    u = max(ulps(a["surface"], b["surface"]) for a, b in zip(outs, host_outs))
    check(u <= QVGA_ULP, f"isc-qvga: FRAME surfaces at {n_win} windows card "
          f"vs CPU port within {QVGA_ULP} ULP ({u})")
    check(all(same(a["count"], b["count"]) for a, b in zip(outs, host_outs)),
          f"isc-qvga: FRAME counts at {n_win} windows card == CPU port, "
          "bitwise")
    v_tw = ecfg.v_tw()
    equal_or_near(f"isc-qvga: FRAME masks at {n_win} windows",
                  torch.stack([o["mask"] for o in outs]),
                  torch.stack([o["mask"] for o in host_outs]),
                  torch.stack([near_v_tw(o["surface"], v_tw)
                               for o in host_outs]))
    mask_spec, stcf_spec = shim_specs(rs)
    ref_read = host.read(mask_spec, t_end)
    ref_sup = host.read(stcf_spec, t_end)["stcf"]
    last = shims["last"]
    equal_or_near("isc-qvga: the shims' readout_with_mask mask at the end",
                  last[2], ref_read["mask"],
                  near_v_tw(ref_read["surface"], v_tw))
    equal_or_near("isc-qvga: the shims' support_map at the end", last[3],
                  ref_sup, near_v_tw(ref_read["surface"], v_tw,
                                     ecfg.stcf_radius))
    u = ulps(last[0], ref_read["surface"])
    check(u <= QVGA_ULP, f"isc-qvga: the shims' readout at the end card vs "
          f"CPU port within {QVGA_ULP} ULP ({u})")
    log(f"isc-qvga: CPU port's FRAME loop and reads {cpu_s:.1f} s")
    return dict(engine=engine, ecfg=ecfg, t_end=t_end, launches=launches,
                frame_launches=frame_launches, n_events=n_events,
                serve_step_p50_ms=p50, serve_step_p99_ms=p99,
                step_ms=step_ms, shim_launches=shims["shim_launches"],
                launches_per_window=shims["launches_per_window"])


def qvga_quickstart(dev, cfg, card) -> dict:
    """Phase 14 (b), part 3: the quickstart pipeline at the array's widths
    on the whole ``hotel_bar`` stream, on the card and on the CPU port:
    supports bitwise, the analog and ideal AUCs and their gap (the
    paper's STCF equivalence), STCF events/s on the card."""
    from repro_torch.core import prng, stcf
    from repro_torch.core.isc_array import ISCArray
    from repro_torch.events import datasets, pipeline

    stream = datasets.dnd21_like("hotel_bar", cfg.h, cfg.w,
                                        QVGA_DURATION, seed=0)
    cap = -(-stream.n // 128) * 128
    runs = []
    for where in (dev, torch.device("cpu")):
        arr = ISCArray(cfg.h, cfg.w, mode=cfg.mode, device=where)
        batch = pipeline.to_event_batch(stream, cap, device=where)
        state = arr.write(arr.init(prng.PRNGKey(0)), batch)
        surface = arr.read(state, QVGA_DURATION)
        labels = torch.from_numpy(np.pad(stream.is_signal,
                                         (0, cap - stream.n))).to(where)
        r = {"surface": surface.cpu()}
        for mode in ("edram", "ideal"):
            if where.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            sup, _ = stcf.stcf_chunked(batch, cfg.h, cfg.w, chunk=128,
                                       mode=mode)
            if where.type == "cuda":
                torch.cuda.synchronize()
            r[f"{mode}_s"] = time.perf_counter() - t0
            r[mode] = sup.cpu()
            r[f"{mode}_auc"] = float(stcf.roc_curve(sup, labels,
                                                    batch.valid)[2])
        runs.append(r)
    g, c = runs
    gap = abs(g["ideal_auc"] - g["edram_auc"])
    log(f"isc-qvga quickstart: hotel_bar at {cfg.h}x{cfg.w}, {stream.n} "
        f"events padded to {cap}; STCF AUC analog {g['edram_auc']:.4f}, "
        f"ideal {g['ideal_auc']:.4f}, gap {gap:.4f}")
    eps = {m: stream.n / g[f"{m}_s"] for m in ("edram", "ideal")}
    log(f"isc-qvga quickstart on {card}: stcf_chunked {g['edram_s']:.3f} s "
        f"analog ({eps['edram']:.1f} events/s), {g['ideal_s']:.3f} s ideal "
        f"({eps['ideal']:.1f} events/s); CPU port {c['edram_s']:.3f} s, "
        f"{c['ideal_s']:.3f} s")
    check(same(g["edram"], c["edram"]) and same(g["ideal"], c["ideal"]),
          f"isc-qvga quickstart: supports (analog and ideal) card == CPU "
          f"port, bitwise ({cap} events)")
    check(abs(g["edram_auc"] - c["edram_auc"]) <= AUC_TOL
          and abs(g["ideal_auc"] - c["ideal_auc"]) <= AUC_TOL,
          f"isc-qvga quickstart: AUCs card vs CPU port within {AUC_TOL} "
          f"(analog {g['edram_auc']!r} / {c['edram_auc']!r}, ideal "
          f"{g['ideal_auc']!r} / {c['ideal_auc']!r})")
    u = ulps(g["surface"], c["surface"])
    check(u <= QVGA_ULP, f"isc-qvga quickstart: analog surface card vs CPU "
          f"port within {QVGA_ULP} ULP ({u})")
    return dict(events=stream.n, padded=cap, auc=g["edram_auc"],
                auc_ideal=g["ideal_auc"], auc_gap=gap,
                stcf_events_per_s=eps, stcf_s=(g["edram_s"], g["ideal_s"]))


def qvga_fused_ref(dev, mods, qs) -> None:
    """Phase 14 (b), part 4: ``ref.ts_fused_ref`` on the card against the
    ``chunk_scatter`` kernel then the ``ts_decay`` kernel on one 10 ms
    push into sensor 0's surface: SAE, surface and mask bitwise.  Its
    launches are a check's and not counted."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.events import datasets
    from repro_torch.kernels import ref

    ecfg, t_end = qs["ecfg"], qs["t_end"]
    s = datasets.dnd21_like("driving", ecfg.h, ecfg.w, QVGA_DURATION,
                                   seed=QVGA_FUSED_SEED)
    ev = pipeline.to_event_batch(s.window(t_end - 0.01, t_end), device=dev)
    sae = qs["engine"].state.surfaces.sae[0].clone()
    params, v_tw = ecfg.decay_params(), ecfg.v_tw()
    p = torch.zeros_like(ev.p)             # one plane: polarity merged
    snap = dict(_lib.LAUNCHES)
    want = ref.ts_fused_ref(sae, ev.x, ev.y, p, ev.t, t_end, params, v_tw)
    new = sae[None].clone()
    ops.chunk_scatter_(new, torch.zeros(1, dtype=torch.int32, device=dev),
                       ts.EventBatch(*(f[None] for f in ev)))
    got = (new[0], *ops.ts_decay_with_mask(new[0], t_end, params, v_tw))
    torch.cuda.synchronize()
    _lib.LAUNCHES.update(snap)
    check(all(same(a, b) for a, b in zip(got, want))
          and not same(want[0], sae),
          f"isc-qvga: ref.ts_fused_ref == chunk_scatter -> ts_decay kernels "
          f"on a 10 ms push of {int(ev.valid.sum())} events: SAE, surface "
          f"and mask bitwise")


def leftovers_phase(dev, mods, card) -> dict:
    """Phase 14: the paper-facing leftovers -- the three torch examples
    (a) and the paper's ``isc-qvga`` array at full width (b)."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.configs import get_config
    from repro_torch.events import datasets

    times = {}
    t0 = time.perf_counter()
    ex = examples_phase(_lib)
    times["examples"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = get_config(ISC_ARCH)
    check((cfg.h, cfg.w, cfg.polarities) == (240, 320, 1),
          f"{ISC_ARCH}: {cfg}")
    streams = [datasets.dnd21_like(k, cfg.h, cfg.w, QVGA_DURATION, seed=i)
               for i, k in enumerate(QVGA_SCENES)]
    half = QVGA_WINDOW_S / 2
    n_bursts = 2 * round(QVGA_DURATION / QVGA_WINDOW_S)
    bursts = [[aer.pack(s.window(b * half, (b + 1) * half)) for s in streams]
              for b in range(n_bursts)]
    log(f"isc-qvga: {[s.n for s in streams]} events "
        f"({time.perf_counter() - t0:.1f} s of host data)")
    times["data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qs = qvga_serve(dev, mods, cfg, bursts, card)
    times["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qq = qvga_quickstart(dev, cfg, card)
    times["quickstart"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qvga_fused_ref(dev, mods, qs)
    times["ts_fused_ref"] = time.perf_counter() - t0
    log(f"leftovers: phase 14 seconds by part "
        f"{ {k: round(v, 1) for k, v in times.items()} }")
    qs = {k: v for k, v in qs.items() if k not in ("engine", "ecfg")}
    return dict(examples=ex, isc_qvga=qs, quickstart=qq, seconds=times)


# ------------------------------------------------- phase 15: over a mesh

MESH_ARCH = "qwen3-8b"
MESH_ONE = (2, 8, 2048, 2)          # (a): layers, batch, seq, steps
MESH_MOE = ("grok-1-314b", 1, 256)  # (a): arch, layers, tokens
MESH_FULL = (32, 2048, 1, 3)        # (b) 1: batch, seq, warm-up, timed steps
MESH_MAMBA = ("mamba2-2.7b", 2048, 1, 2)   # (b) 2: arch, seq, warm-up, timed
MESH_CHECK = (2, 32, 256, 3)        # (b) 3, 4: layers, batch, seq, steps
#: (b) 3: batches whose microbatches the N = 4 data ranks do not divide
MESH_UNEVEN = (24, 16)
MESH_PP = (8, 8, 4096)              # (b) 5: microbatches, rows, width
MESH_TOL = 1e-4    # rtol; atol x max|leaf|: a mesh against one card
#: the learning rate of the uncut run, whose loss must fall in 3 steps
#: (the schedule's lr is 0 at step 0; one warm-up step)
MESH_LR = dict(lr=3e-4, warmup_steps=1)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> float:
    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0.0)


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


class MeshRun:
    """One rank's side of phase 15: its results and failed checks, which
    ``mesh_rank`` writes for the parent to read."""

    def __init__(self, rank, n, device):
        self.rank, self.n, self.device = rank, n, device
        self.res = {"failures": []}

    def log(self, msg, every=False):
        if every or self.rank == 0:
            log(f"  mesh rank {self.rank}/{self.n}: {msg}")

    def check(self, ok, what, every=False):
        if every or self.rank == 0:
            self.log(f"[{'ok' if ok else 'FAIL'}] {what}", every=True)
        if not ok:
            self.res["failures"].append(f"rank {self.rank}: {what}")


def _leaf_errors(run, mesh_tree, shards, want, tol):
    """Gather each leaf of ``mesh_tree`` (on every rank) and compare it on
    rank 0 with ``want[path]`` (a CPU tensor): the leaves outside rtol =
    ``tol``, atol = ``tol`` x max|want|, and the worst error as a share
    of its leaf's max.  ``tol`` None: bitwise."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import module as M

    bad, worst = [], 0.0
    for (k, x), pl in zip(M.flatten(mesh_tree).items(),
                          M.flatten(shards).values()):
        full = SH.gather_full(x, pl)
        if run.rank == 0:
            w = want[k].to(full.device)
            if tol is None:
                ok = torch.equal(full, w)
            else:
                scale = float(w.abs().max())
                err = float((full - w).abs().max())
                worst = max(worst, err / max(scale, 1e-30))
                ok = bool(torch.allclose(full, w, rtol=tol,
                                         atol=tol * scale))
            if not ok:
                bad.append(k)
        del full
    return bad, worst


def _host_leaves(tree):
    from repro_torch.models import module as M

    return {k: v.detach().cpu() for k, v in M.flatten(tree).items()}


def mesh_one(run):
    """Phase 15 (a): a mesh of one NCCL rank against the one-card
    trainer, and ``moe_sharded`` at grok-1's widths against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.events.pipeline import TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import module as M
    from repro_torch.train import loop

    layers, batch, seq, steps = MESH_ONE
    cfg = dataclasses.replace(get_config(MESH_ARCH), n_layers=layers)
    mesh = make_test_mesh((1, 1), device=run.device)
    dev = mesh.device
    t0 = time.perf_counter()
    one = loop.Trainer(cfg, loop.TrainerConfig(), device=dev)
    one.train(TokenPipeline(cfg.vocab, batch, seq, seed=0), steps)
    want, want_loss = _host_leaves(one.params), [h["loss"] for h in
                                                 one.history]
    del one
    _reset_peak(dev)
    tr = loop.Trainer(cfg, loop.TrainerConfig(), mesh=mesh)
    tr.train(TokenPipeline(cfg.vocab, batch, seq, seed=0), steps)
    got_loss = [h["loss"] for h in tr.history]
    bad = [k for k, v in M.flatten(tr.params).items()
           if not torch.equal(v.cpu(), want[k])]
    _sync(dev)
    run.check(got_loss == want_loss and not bad,
              f"{MESH_ARCH} at full widths, {layers} layers, batch {batch} x "
              f"{seq}, {steps} steps on a (1, 1) mesh: losses {got_loss} and "
              f"all {len(want)} parameter leaves bitwise the one-card "
              f"Trainer's (unequal: {bad}) "
              f"[{time.perf_counter() - t0:.1f} s]")
    run.res["one"] = dict(losses=got_loss, bitwise=not bad)
    del tr, want
    _reset_peak(dev)
    run.res["moe"] = mesh_moe(run, dev)


def mesh_moe(run, dev):
    """``moe_sharded`` (``ep`` at model = 1) at grok-1's full widths on
    the card against the CPU port's on the same inputs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.models import moe as MOE

    arch, layers, tokens = MESH_MOE
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              dtype="float32")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(15)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    rnd = lambda *shape, fan: (torch.randn(shape, generator=g, device=dev)
                               / fan ** 0.5)
    w = {"router": rnd(d, e, fan=d), "we_gate": rnd(e, d, f, fan=d),
         "we_up": rnd(e, d, f, fan=d), "we_down": rnd(e, f, d, fan=f)}
    x = rnd(1, tokens, d, fan=1)
    card_mesh = ProcessMesh(("data", "model"), (1, 1), 0, dev, {})
    cpu_mesh = ProcessMesh(("data", "model"), (1, 1), 0,
                           torch.device("cpu"), {})
    with torch.no_grad():
        y, aux = MOE.moe_sharded(w, x, cfg, card_mesh)
        idx = MOE.route(w["router"], x.reshape(-1, d), cfg)[0]
        wc = {k: v.cpu() for k, v in w.items()}
        del w
        yc, auxc = MOE.moe_sharded(wc, x.cpu(), cfg, cpu_mesh)
        idxc = MOE.route(wc["router"], x.cpu().reshape(-1, d), cfg)[0]
    flipped = int((idx.cpu() != idxc).any(-1).sum())
    err, ok = close(y, yc, MESH_TOL)
    aux_ok = all(abs(float(aux[k]) - float(auxc[k]))
                 <= MESH_TOL * abs(float(auxc[k])) for k in aux)
    run.check(flipped == 0 and ok and aux_ok,
              f"moe_sharded (ep, model = 1) at {arch}'s widths (d_model {d}, "
              f"{e} experts of {f}), {tokens} tokens, float32: card vs CPU "
              f"max |err| {err:.3e} within rtol {MESH_TOL}, atol {MESH_TOL} x "
              f"max(1, max|CPU|); {flipped} routings flipped; aux losses "
              f"within {MESH_TOL} relative "
              f"[{time.perf_counter() - t0:.1f} s]")
    return dict(max_abs_err=err, flipped=flipped)


def mesh_cards(run):
    """Phase 15 (b): the trainer over N cards."""
    mesh_full(run)
    mesh_mamba(run)
    mesh_check(run)
    mesh_pp(run)


def mesh_full(run):
    """(b) 1: qwen3-8b uncut, FSDP over (N, 1)."""
    import math

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.events.pipeline import TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import module as M
    from repro_torch.train import loop

    batch, seq, warm, timed = MESH_FULL
    cfg = get_config(MESH_ARCH)
    mesh = make_test_mesh((run.n, 1), device=run.device)
    dev = mesh.device
    _reset_peak(dev)
    t0 = time.perf_counter()
    tr = loop.Trainer(cfg, loop.TrainerConfig(**MESH_LR), mesh=mesh)
    _sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(math.prod(pl.shape) for pl in M.flatten(tr.shards).values())
    alloc = (torch.cuda.memory_allocated(dev) if dev.type == "cuda"
             else 0) / 2**30
    run.log(f"{MESH_ARCH} uncut ({cfg.n_layers} layers, {n_params} float32 "
            f"parameters, fsdp {cfg.fsdp}, {cfg.n_microbatches} "
            f"microbatches, remat {cfg.remat}) over ({run.n}, 1): each "
            f"rank's blocks and optimizer state in {init_s:.1f} s, "
            f"{alloc:.2f} GiB")
    pipe = TokenPipeline(cfg.vocab, batch, seq, seed=0)

    def step():
        _sync(dev)
        mesh.barrier()
        t = time.perf_counter()
        tr.train(pipe, 1)
        _sync(dev)
        mesh.barrier()
        return (time.perf_counter() - t) * 1e3

    warm_ms = [step() for _ in range(warm)]
    ms = [step() for _ in range(timed)]
    peak = _peak(dev)
    med = statistics.median(ms)
    if run.rank == 0:
        prof = profiled_kernels(lambda: tr.train(pipe, 1))
    else:
        tr.train(pipe, 1)
        prof = None
    losses = [h["loss"] for h in tr.history]
    peaks = [None] * run.n
    dist.all_gather_object(peaks, peak)
    tokens = batch * seq
    run.res["full"] = dict(step_ms=ms, warm_ms=warm_ms, median_ms=med,
                           tokens_per_s=tokens * 1e3 / med,
                           peak_gib=[p / 2**30 for p in peaks],
                           losses=losses, init_s=init_s, params=n_params)
    if prof is not None:
        nccl = sum(v for k, v in prof["kernels"].items()
                   if "nccl" in k.lower())
        run.res["full"].update(
            device_ms=prof["device_ms"], nccl_ms=nccl,
            compute_ms=prof["device_ms"] - nccl, wall_ms=prof["wall_ms"],
            launches=prof["launches"],
            top=sorted(((k[:60], v) for k, v in prof["kernels"].items()),
                       key=lambda kv: -kv[1])[:8])
        run.log(f"{MESH_ARCH} uncut over {run.n} cards: step ms "
                f"{[round(v, 1) for v in ms]} -> median {med:.1f} ms, "
                f"{tokens * 1e3 / med:.1f} tokens/s ({batch} x {seq} a step);"
                f" peak allocated GiB by card "
                f"{[round(p / 2**30, 2) for p in peaks]}; losses "
                f"{[round(v, 4) for v in losses]}")
        run.log(f"profiled step on rank 0: {prof['device_ms']:.1f} ms device "
                f"time of {prof['wall_ms']:.1f} ms, NCCL kernels {nccl:.1f} ms "
                f"({100 * nccl / max(prof['device_ms'], 1e-9):.1f} %), "
                f"compute {prof['device_ms'] - nccl:.1f} ms; "
                f"{prof['launches']} kernels")
    run.check(all(math.isfinite(v) for v in losses)
              and losses[warm + timed - 1] < losses[0],
              f"every loss finite; step {warm + timed - 1}'s "
              f"{losses[warm + timed - 1]:.4f} below step 0's {losses[0]:.4f}")
    run.check(all(p < 80e9 for p in peaks),
              f"every card's peak under 80 GB: "
              f"{[round(p / 1e9, 2) for p in peaks]} GB")
    del tr
    _reset_peak(dev)


def mesh_mamba(run):
    """(b) 2: mamba2-2.7b uncut over (N, 1), phase 11 (a)'s work a card."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.events.pipeline import TokenPipeline
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import loop

    arch, seq, warm, timed = MESH_MAMBA
    cfg = get_config(arch)
    mesh = make_test_mesh((run.n, 1), device=run.device)
    dev = mesh.device
    _reset_peak(dev)
    tr = loop.Trainer(cfg, loop.TrainerConfig(), mesh=mesh)
    batch = cfg.n_microbatches * run.n
    pipe = TokenPipeline(cfg.vocab, batch, seq, seed=0)

    def step():
        _sync(dev)
        mesh.barrier()
        t = time.perf_counter()
        tr.train(pipe, 1)
        _sync(dev)
        mesh.barrier()
        return (time.perf_counter() - t) * 1e3

    for _ in range(warm):
        step()
    _lib.reset_launches()
    ms = [step() for _ in range(timed)]
    launches = {k: v / timed for k, v in _lib.LAUNCHES.items() if v}
    peak = _peak(dev)
    med = statistics.median(ms)
    fwd = 2 * cfg.n_layers * cfg.n_microbatches
    bwd = cfg.n_layers * cfg.n_microbatches
    run.check(launches.get("decay_scan") == fwd
              and launches.get("decay_scan_bwd") == bwd,
              f"{arch} over {run.n} cards: decay_scan launched {fwd} and "
              f"decay_scan_bwd {bwd} times a step on this rank ({launches})",
              every=True)
    everyone = [None] * run.n
    dist.all_gather_object(everyone, launches)
    run.res["mamba"] = dict(step_ms=ms, median_ms=med, batch=batch, seq=seq,
                            tokens_per_s=batch * seq * 1e3 / med,
                            peak_gib=peak / 2**30, launches=launches,
                            launches_by_rank=everyone,
                            losses=[h["loss"] for h in tr.history])
    run.log(f"{arch} uncut over {run.n} cards: batch {batch} x {seq}, step ms "
            f"{[round(v, 1) for v in ms]} -> {batch * seq * 1e3 / med:.1f} "
            f"tokens/s; peak {peak / 2**30:.2f} GiB on rank 0")
    del tr
    _reset_peak(dev)


def mesh_check(run):
    """(b) 3, 4: qwen3-8b at full widths and 2 layers over (N, 1) and
    (2, 2) against the one-card trainer; ``fsdp_gather_once``; over
    (N, 1) at the batches of ``MESH_UNEVEN``, whose microbatches the data
    ranks do not divide (padded blocks), against the one-card trainer at
    that batch; the (N, 1) checkpoint restored onto another mesh and onto
    one card."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.events.pipeline import TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import loop

    layers, batch, seq, steps = MESH_CHECK
    cfg = dataclasses.replace(get_config(MESH_ARCH), n_layers=layers,
                              dtype="float32")
    mesh = make_test_mesh((run.n, 1), device=run.device)
    dev = mesh.device
    card = _card_name(dev) if run.rank == 0 else None
    t0 = time.perf_counter()
    box = [tempfile.mkdtemp(prefix="smoke_mesh_ckpt_") if run.rank == 0
           else None]
    dist.broadcast_object_list(box, src=0)
    ckpt = box[0]
    alt = (2, 2) if run.n == 4 else (1, run.n)
    cases = ([((run.n, 1), False, batch), (alt, False, batch),
              ((run.n, 1), True, batch)]
             + [((run.n, 1), False, b) for b in MESH_UNEVEN])
    out = {}
    keep, one_batch = None, None
    for shape, once, b in cases:
        pipe = lambda b=b: TokenPipeline(cfg.vocab, b, seq, seed=0)
        if b != one_batch:
            one_batch = b
            want, want_m, want_loss, one_ms = None, None, None, None
            if run.rank == 0:
                one = loop.Trainer(cfg, loop.TrainerConfig(**MESH_LR),
                                   device=dev)
                one.train(pipe(), steps)
                want, want_m = (_host_leaves(one.params),
                                _host_leaves(one.opt_state["m"]))
                want_loss = [h["loss"] for h in one.history]
                one_ms = [1e3 * h["dt"] for h in one.history]
                del one
                _reset_peak(dev)
            mesh.barrier()
        m = make_test_mesh(shape, device=run.device)
        c = dataclasses.replace(cfg, fsdp_gather_once=once)
        saved = shape == (run.n, 1) and not once and b == batch
        tr = loop.Trainer(c, loop.TrainerConfig(
            **MESH_LR, ckpt_dir=ckpt if saved else None), mesh=m)
        tr.train(pipe(), steps)
        losses = [h["loss"] for h in tr.history]
        ms = [1e3 * h["dt"] for h in tr.history]
        bad, worst = _leaf_errors(run, tr.params, tr.shards, want, MESH_TOL)
        bad_m, worst_m = _leaf_errors(run, tr.opt_state["m"], tr.shards,
                                      want_m, MESH_TOL)
        tag = f"{shape}{' gather-once' if once else ''}"
        rows = b // cfg.n_microbatches
        if b != batch:
            tag += f" batch {b}"
        if run.rank == 0:
            pad = (f" ({rows} rows a microbatch over {run.n} data ranks: "
                   f"padded blocks)" if rows % run.n else "")
            lerr = max(abs(a - w) / abs(w) for a, w in zip(losses, want_loss))
            run.check(lerr <= 1e-5 and not bad_m,
                      f"{MESH_ARCH} at full widths, {layers} layers, batch "
                      f"{b} x {seq}{pad}, {steps} steps over {tag} against "
                      f"the one-card trainer: losses within {lerr:.2e} "
                      f"relative (1e-5); AdamW's first moments (the clipped "
                      f"gradients) in rtol {MESH_TOL}, atol {MESH_TOL} x "
                      f"max|leaf| (worst {worst_m:.2e} of its leaf's max; "
                      f"outside: {bad_m})")
            run.log(f"{tag}: parameters, not held (Adam's per-cell "
                    f"normalisation): worst {worst:.2e} of a leaf's max, "
                    f"{len(bad)} leaves outside the band {bad}; ms a step "
                    f"{[round(v, 1) for v in ms]}, on one card "
                    f"{[round(v, 1) for v in one_ms]} (step 0 warms up; "
                    f"{card})")
            out[tag] = dict(loss_rel_err=lerr, worst=worst, worst_m=worst_m,
                            ms=ms, one_card_ms=one_ms, card=card)
        if saved:
            tr.save()
            keep = tr
        else:
            del tr
    run.res["check"] = out
    mesh_restore(run, cfg, keep, ckpt,
                 lambda: TokenPipeline(cfg.vocab, batch, seq, seed=0), steps)
    del keep
    _reset_peak(dev)
    if run.rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    run.log(f"(b) 3, 4 took {time.perf_counter() - t0:.1f} s")


def _card_name(dev) -> str:
    """``nvidia-smi``'s name and power limit of the card ``dev``."""
    smi = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    return smi or "nvidia-smi gave nothing"


def mesh_restore(run, cfg, src, ckpt, pipe, steps):
    """(b) 4: the (N, 1) checkpoint onto another mesh and one card."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import loop

    t0 = time.perf_counter()
    alt = (2, 2) if run.n == 4 else (1, run.n)
    m = make_test_mesh(alt, device=run.device)
    tcfg = loop.TrainerConfig(**MESH_LR, ckpt_dir=ckpt)
    tr = loop.Trainer(cfg, tcfg, mesh=m)
    assert tr.maybe_restore() and tr.step == steps
    src_state = _host_gather(run, (src.params, src.opt_state),
                             src._shardings())
    bad, _ = _leaf_errors(run, (tr.params, tr.opt_state), tr._shardings(),
                          src_state, None)
    run.check(not bad, f"the ({run.n}, 1) checkpoint restored onto {alt}: "
              f"parameters and optimizer state bitwise (unequal: {bad}) "
              f"[{time.perf_counter() - t0:.1f} s]")
    one = None
    if run.rank == 0:
        one = loop.Trainer(cfg, tcfg, device=m.device)
        assert one.maybe_restore() and one.step == steps
        got = _host_leaves((one.params, one.opt_state))
        bad = [k for k in src_state if not torch.equal(got[k], src_state[k])]
        run.check(not bad, f"the ({run.n}, 1) checkpoint restored onto one "
                  f"card: bitwise (unequal: {bad})")
        del got
    # one more step on each, from the restored pipeline position
    p = pipe()
    p.state = dataclasses.replace(p.state, step=steps)
    tr.train(p, 1)
    want = None
    if one is not None:
        p = pipe()
        p.state = dataclasses.replace(p.state, step=steps)
        one.train(p, 1)
        want = _host_leaves(one.opt_state["m"])
        lerr = abs(tr.history[-1]["loss"] - one.history[-1]["loss"]) / abs(
            one.history[-1]["loss"])
        del one
    bad, worst = _leaf_errors(run, tr.opt_state["m"], tr.shards, want,
                              MESH_TOL)
    if run.rank == 0:
        run.check(lerr <= 1e-5 and not bad,
                  f"one more step after the restore: {alt} against one card, "
                  f"loss within {lerr:.2e} relative, AdamW's first moments in "
                  f"the band (worst {worst:.2e}; outside: {bad})")
    del tr


def _host_gather(run, tree, shards):
    """Every leaf gathered whole, kept on rank 0's host (by path)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import module as M

    out = {}
    for (k, x), pl in zip(M.flatten(tree).items(),
                          M.flatten(shards).values()):
        full = SH.gather_full(x, pl)
        if run.rank == 0:
            out[k] = full.cpu()
        del full
    return out


def mesh_pp(run):
    """(b) 5: ``pipeline_forward`` over N stages against the stages run
    in turn on one card, bitwise."""
    from repro_torch.distributed import pp
    from repro_torch.launch.mesh import make_test_mesh

    n_micro, mb, d = MESH_PP
    mesh = make_test_mesh((run.n,), ("stage",), device=run.device)
    dev = mesh.device
    g = torch.Generator().manual_seed(5)
    ws = (torch.randn(run.n, d, d, generator=g) / d ** 0.5).to(dev)
    x = torch.randn(n_micro, mb, d, generator=g).to(dev)
    stage = lambda w, h: torch.tanh(h @ w)
    got = pp.pipeline_forward(stage, ws, x, mesh)
    if run.rank == 0:
        # each microbatch through the stages: the pipeline's shapes (a
        # GEMM of other rows may take another cuBLAS kernel)
        want = x.clone()
        for i in range(n_micro):
            for s in range(run.n):
                want[i] = stage(ws[s], want[i])
        run.check(torch.equal(got, want),
                  f"pipeline_forward: {run.n} stages x {n_micro} microbatches "
                  f"of ({mb}, {d}) over {run.n} cards bitwise the stages run "
                  f"in turn on card 0 (bubble {pp.bubble(run.n, n_micro):.3f})")


# --------------------------------------- phase 16: serving over a mesh

SERVE_ONE = (("qwen3-8b", 2), ("hymba-1.5b", 2))   # (a): full widths, layers
SERVE_ONE_PROMPT = (256, 512)        # (a): LM traffic with shorter prompts
SERVE_FULL = "gemma2-27b"            # (b) 1: uncut over (1, N)
SERVE_FULL_WIDTHS = (46, 4608, 32, 16, 128, 36864, 256000, 4096)
SERVE_HYBRID = "hymba-1.5b"          # (b) 2: uncut over (2, 2) or (N, 1)
#: (b) 3, float32: (arch, layers, (requests, prompt lengths, tokens)); the
#: last case's prompts pass hymba's window of 1,024, so its rolled ring
#: splits over (1, N) and (2, 2)
SERVE_CHECK = (("gemma2-27b", 2, (4, (192, 320), 8)),
               ("hymba-1.5b", 2, (4, (192, 320), 8)),
               ("hymba-1.5b", 2, (4, (1100, 1300), 8)))
SERVE_TOL = 1e-4  # rtol; atol x max(1, max|one card|): a mesh against one card


def serve_requests(cfg, lens, n=None, new=None, seed=0):
    """``lm_requests``' traffic (``n`` requests, default LM_REQUESTS, of
    ``new`` tokens, default LM_NEW_TOKENS) with prompt lengths drawn in
    ``lens``."""
    from repro_torch.serve.engine import Request

    n = LM_REQUESTS if n is None else n
    new = LM_NEW_TOKENS if new is None else new
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lens[0], lens[1] + 1, n)
    return [Request(rng.integers(0, cfg.vocab, k).astype(np.int32),
                    max_new_tokens=new) for k in sizes]


class ServeRecorder:
    """Wraps a ``ServeEngine``'s prefill and decode: each call timed on
    the host clock ending in a synchronize (and a barrier on every rank
    of a mesh), with its ``decay_scan`` launches and whether every logit
    is finite; with ``keep``, its logits gathered whole (the vocab over
    ``"model"``, the rows over the data axes) onto the host; the caches
    of the last call.  ``profile``: (kind, index) of the one call that
    runs under ``profiled_kernels`` on rank 0 (kept in ``.profile``)."""

    def __init__(self, engine, keep=False, profile=None):
        from repro_torch.distributed import sharding as SH
        from repro_torch.kernels import _lib

        self.calls, self.logits, self.caches, self.profile = [], [], None, None
        # the wrappers close over these, never over the engine: a
        # dropped engine frees its parameters at once
        mesh, dev, layout = engine.mesh, engine.device, engine._layout

        def whole(lg):
            if mesh is None:
                return lg.cpu()
            lg = SH.all_gather_dim(lg, mesh, "model", -1)
            bspec = SH.batch_spec(mesh, layout["batch"])
            return SH.all_gather_dim(lg, mesh, bspec[0] if bspec else (),
                                     0).cpu()

        def wrap(kind, fn):
            seen = [0]

            def run(*args):
                _sync(dev)
                if mesh is not None:
                    mesh.barrier()
                n0 = _lib.LAUNCHES["decay_scan"]
                t0 = time.perf_counter()
                if profile == (kind, seen[0]) and (mesh is None
                                                   or mesh.rank == 0):
                    box = []
                    self.profile = profiled_kernels(
                        lambda: box.append(fn(*args)))
                    out = box[0]
                else:
                    out = fn(*args)
                _sync(dev)
                if mesh is not None:
                    mesh.barrier()
                seen[0] += 1
                self.calls.append((kind, time.perf_counter() - t0,
                                   _lib.LAUNCHES["decay_scan"] - n0,
                                   bool(torch.isfinite(out[0]).all())))
                if keep:
                    self.logits.append(whole(out[0]))
                self.caches = out[1]
                return out
            return run

        engine._prefill = wrap("prefill", engine._prefill)
        engine._decode = wrap("decode", engine._decode)

    def times(self, kind):
        return [c[1] for c in self.calls if c[0] == kind]


@contextlib.contextmanager
def scan_inputs(box: list):
    """While open, ``box`` keeps copies of the inputs (a, x, s0) of the
    first ``ops.decay_scan`` call on this rank: the hybrid prefill's own,
    which goes on to launch and count as usual."""
    from repro_torch.kernels import ops

    real = ops.decay_scan

    def seen(a, x, s0=None):
        if not box:
            box[:] = [t if t is None else t.detach().clone()
                      for t in (a, x, s0)]
        return real(a, x, s0)

    ops.decay_scan = seen
    try:
        yield box
    finally:
        ops.decay_scan = real


def hold_scan(run, what: str, box: list) -> dict:
    """``decay_scan`` on the inputs ``box`` kept from this rank's prefill
    (``scan_inputs``), against its plain version, bitwise: the kernel at
    the shape the mesh path gives it on this rank.  These launches come
    after the path's counts were read."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decay_scan import decay_scan_cuda

    if not box:
        run.check(False, f"{what}: no decay_scan call was seen on this rank",
                  every=True)
        return {}
    a, x, s0 = box
    if a.device.type != "cuda":
        run.check(False, f"{what}: decay_scan's inputs lie on {a.device}; "
                  f"the kernel runs only on a card", every=True)
        return {}
    got, want = decay_scan_cuda(a, x, s0), ref.decay_scan_ref(a, x, s0)
    ok = all(same(u, v) for u, v in zip(got, want))
    err = max(float((u - v).abs().max()) for u, v in zip(got, want))
    run.check(ok, f"{what}: decay_scan on this rank's own prefill inputs "
              f"{tuple(a.shape)} (s0 {'none' if s0 is None else 'given'}) "
              f"== its plain version bitwise (max |d| {err:.3e})",
              every=True)
    return dict(shape=list(a.shape), max_abs_err=err, bitwise=ok)


def serve_one(run):
    """Phase 16 (a): ``ServeEngine(mesh=)`` on a (1, 1) mesh of one NCCL
    rank against the one-card ``ServeEngine``, bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    mesh = make_test_mesh((1, 1), device=run.device)
    dev = mesh.device
    out = {}
    for arch, layers in SERVE_ONE:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        params = M.init_params(T.param_defs(cfg), prng.PRNGKey(0), dev)
        reqs = serve_requests(cfg, SERVE_ONE_PROMPT)
        max_len = SERVE_ONE_PROMPT[1] + LM_NEW_TOKENS
        one = ServeEngine(cfg, params, max_len=max_len, device=dev)
        ro = ServeRecorder(one, keep=True)
        want = one.serve(reqs)
        eng = ServeEngine(cfg, params, max_len=max_len, mesh=mesh)
        rm = ServeRecorder(eng, keep=True)
        box = []
        _lib.reset_launches()
        with scan_inputs(box):
            got = eng.serve(reqs)
        launches = dict(_lib.LAUNCHES)
        toks = all(np.array_equal(a.tokens, b.tokens)
                   for a, b in zip(got, want))
        logits = (len(rm.logits) == len(ro.logits) == LM_NEW_TOKENS and all(
            torch.equal(a, b) for a, b in zip(rm.logits, ro.logits)))
        ca, cb = M.flatten(rm.caches), M.flatten(ro.caches)
        caches = ca.keys() == cb.keys() and all(torch.equal(ca[k], cb[k])
                                                for k in ca)
        run.check(toks and logits and caches,
                  f"{arch} at full widths, {layers} layers, bf16: "
                  f"ServeEngine over a (1, 1) mesh on {LM_REQUESTS} requests "
                  f"of {sorted(len(r.prompt) for r in reqs)} prompt tokens, "
                  f"{LM_NEW_TOKENS} greedy tokens: tokens {toks}, every "
                  f"call's logits {logits} ({len(rm.logits)} calls) and the "
                  f"caches {caches} bitwise the one-card engine's "
                  f"[{time.perf_counter() - t0:.1f} s]")
        pre = [c[2] for c in rm.calls if c[0] == "prefill"]
        dec = [c[2] for c in rm.calls if c[0] == "decode"]
        scan = None
        if cfg.family == "hybrid":
            run.check(pre == [layers] and not any(dec)
                      and launches["decay_scan"] == layers,
                      f"{arch} over the (1, 1) mesh: decay_scan launched "
                      f"{pre} times by the prefill (one a layer) and "
                      f"{sum(dec)} by the decode steps; {launches}")
            scan = hold_scan(run, f"{arch} over the (1, 1) mesh", box)
        out[arch] = dict(tokens=toks, logits=logits, caches=caches,
                         launches=launches, scan=scan,
                         prefill_ms=1e3 * rm.times("prefill")[0],
                         decode_p50_ms=1e3 * float(np.percentile(
                             rm.times("decode"), 50)))
        del one, eng, ro, rm, params
        _reset_peak(dev)
    run.res["serve_one"] = out


def serve_cards(run):
    """Phase 16 (b): LM serving over N cards."""
    serve_full(run)
    serve_hybrid(run)
    serve_check(run)


def _blocks(cfg, mesh, key):
    """This rank's blocks of ``cfg``'s parameters drawn from ``key``."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T

    pls = M.flatten(SH.placements(cfg, mesh))
    return M.init_params(T.param_defs(cfg), key, mesh.device,
                         blocks={k: pl.block() for k, pl in pls.items()})


def _served_over(run, cfg, mesh, what, reqs, max_len, profile=False,
                 box=None):
    """``cfg`` uncut on its blocks (``PRNGKey(0)``) served over ``mesh``:
    a warm-up serve (3 tokens; its second decode step profiled on rank 0
    with ``profile``), then the timed serve with the launch counters
    zeroed just before and read just after (with ``box``, the inputs of
    its first ``decay_scan`` kept there: ``scan_inputs``).  Checks every
    logit finite, every token in the vocab, every card's peak under 80
    GB."""
    import math

    import torch.distributed as dist

    from repro_torch.core import prng
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import _lib
    from repro_torch.models import module as M
    from repro_torch.serve.engine import Request, ServeEngine

    dev = mesh.device
    _reset_peak(dev)
    t0 = time.perf_counter()
    blocks = _blocks(cfg, mesh, prng.PRNGKey(0))
    _sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(math.prod(pl.shape) for pl in
                   M.flatten(SH.placements(cfg, mesh)).values())
    eng = ServeEngine(cfg, blocks, max_len=max_len, mesh=mesh)
    rec = ServeRecorder(eng, profile=("decode", 1) if profile else None)
    t0 = time.perf_counter()
    eng.serve([Request(r.prompt, max_new_tokens=3) for r in reqs])
    warm_s = time.perf_counter() - t0
    rec.calls.clear()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _lib.reset_launches()
    t0 = time.perf_counter()
    with scan_inputs(box) if box is not None else contextlib.nullcontext():
        results = eng.serve(reqs)
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    peaks = [None] * run.n
    dist.all_gather_object(peaks, _peak(dev))
    s_max = max(len(r.prompt) for r in reqs)
    pf = rec.times("prefill")
    dec = [1e3 * t for t in rec.times("decode")]
    toks = np.stack([r.tokens for r in results])
    r = dict(mesh=mesh.shape, params=n_params, init_s=init_s,
             warm_s=warm_s, serve_s=wall, prefill_ms=1e3 * pf[0],
             prefill_tokens_per_s=len(reqs) * s_max / pf[0],
             decode_ms=dec, decode_p50_ms=float(np.percentile(dec, 50)),
             decode_p99_ms=float(np.percentile(dec, 99)),
             peak_gib=[p / 2**30 for p in peaks], launches=launches,
             prefill_launches=[c[2] for c in rec.calls if c[0] == "prefill"],
             decode_launches=[c[2] for c in rec.calls if c[0] == "decode"],
             tokens=toks.tolist())
    run.log(f"{what} over {mesh.shape} ({n_params} float32 parameters, "
            f"each rank's blocks drawn in {init_s:.1f} s): {len(reqs)} "
            f"requests, prompts {sorted(len(q.prompt) for q in reqs)} "
            f"(left-padded to {s_max}); prefill {1e3 * pf[0]:.1f} ms -> "
            f"{r['prefill_tokens_per_s']:.1f} tokens/s; decode step p50 "
            f"{r['decode_p50_ms']:.2f} ms, p99 {r['decode_p99_ms']:.2f} ms "
            f"over {len(dec)} steps; serve {wall:.2f} s (warm-up "
            f"{warm_s:.1f} s); peak allocated GiB by card "
            f"{[round(p / 2**30, 2) for p in peaks]}")
    if rec.profile is not None:
        prof = rec.profile
        nccl = sum(v for k, v in prof["kernels"].items() if "nccl" in k.lower())
        r.update(profile_device_ms=prof["device_ms"],
                 profile_wall_ms=prof["wall_ms"], nccl_ms=nccl,
                 profile_launches=prof["launches"],
                 top=sorted(((k[:60], v) for k, v in prof["kernels"].items()),
                            key=lambda kv: -kv[1])[:8])
        run.log(f"{what}: one profiled decode step on rank 0: "
                f"{prof['device_ms']:.2f} ms device time of "
                f"{prof['wall_ms']:.2f} ms, NCCL kernels {nccl:.2f} ms "
                f"({100 * nccl / max(prof['device_ms'], 1e-9):.1f} % of "
                f"device time), {prof['launches']} kernels; top "
                f"{[(k, round(v, 2)) for k, v in r['top'][:5]]}")
    run.check(len(pf) == 1 and len(dec) == LM_NEW_TOKENS - 1
              and all(c[3] for c in rec.calls),
              f"{what}: one prefill and {LM_NEW_TOKENS - 1} decode steps on "
              f"this rank, every logit finite", every=True)
    run.check(toks.shape == (len(reqs), LM_NEW_TOKENS) and toks.min() >= 0
              and toks.max() < cfg.vocab,
              f"{what}: tokens {toks.shape} within the true vocab "
              f"[0, {cfg.vocab}) on every rank", every=True)
    run.check(all(p < 80e9 for p in peaks),
              f"{what}: every card's peak under 80 GB: "
              f"{[round(p / 1e9, 2) for p in peaks]} GB")
    del eng, rec, blocks
    _reset_peak(dev)
    return r


def serve_full(run):
    """(b) 1: gemma2-27b uncut over (1, N)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request

    cfg = get_config(SERVE_FULL)
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
              cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.window)
    run.check(widths == SERVE_FULL_WIDTHS
              and cfg.activation_dtype == torch.bfloat16,
              f"{SERVE_FULL} uncut: (layers, d_model, heads, KV heads, "
              f"head_dim, d_ff, vocab, window) {widths}, softcaps "
              f"{cfg.attn_logit_softcap} / {cfg.final_logit_softcap}, bf16")
    mesh = make_test_mesh((1, run.n), device=run.device)
    max_len = LM_PROMPT[1] + LM_NEW_TOKENS
    reqs = lm_requests(cfg, Request)
    splits = {n: SH.cache_seq_axes(mesh, len(reqs), n) for n in {
        T._cache_len(w, max_len) for w in T.layer_windows(cfg)}}
    run.log(f"{SERVE_FULL}: the caches' sequence by ring length: "
            f"{ {n: (a, mesh.count(a)) for n, a in splits.items()} } (axes, "
            f"ways)")
    r = _served_over(run, cfg, mesh, f"{SERVE_FULL} uncut", reqs, max_len,
                     profile=True)
    r["seq_axes"] = {str(n): a for n, a in splits.items()}
    run.check(r["params"] > 27e9 and not any(r["launches"].values()),
              f"{SERVE_FULL}: {r['params'] / 1e9:.2f} B float32 parameters "
              f"({4 * r['params'] / 1e9:.1f} GB: no one card holds them); "
              f"the path launched none of the port's kernels "
              f"({r['launches']})")
    run.res["serve_full"] = r


def serve_hybrid(run):
    """(b) 2: hymba-1.5b uncut over (2, 2), or (N, 1); its tokens beside
    the one-card engine's on the same weights and traffic (phase 13
    (a)'s run, repeated on card 0)."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(SERVE_HYBRID)
    shape = (2, 2) if run.n == 4 else (run.n, 1)
    mesh = make_test_mesh(shape, device=run.device)
    max_len = LM_PROMPT[1] + LM_NEW_TOKENS
    reqs = lm_requests(cfg, Request)
    box = []
    r = _served_over(run, cfg, mesh, f"{SERVE_HYBRID} uncut", reqs, max_len,
                     box=box)
    run.check(r["prefill_launches"] == [cfg.n_layers]
              and r["launches"]["decay_scan"] == cfg.n_layers
              and not any(r["decode_launches"]),
              f"{SERVE_HYBRID} over {shape}: decay_scan launched "
              f"{r['prefill_launches']} times by the prefill on this rank "
              f"(one a layer) and never by the decode steps", every=True)
    r["scan"] = hold_scan(run, f"{SERVE_HYBRID} uncut over {shape}", box)
    if run.rank == 0:
        params = M.init_params(T.param_defs(cfg), prng.PRNGKey(0),
                               mesh.device)
        one = ServeEngine(cfg, params, max_len=max_len, device=mesh.device)
        want = np.stack([q.tokens for q in one.serve(reqs)])
        got = np.array(r["tokens"])
        agree = float((got == want).mean())
        first = [int(np.argmax(g != w)) if (g != w).any() else None
                 for g, w in zip(got, want)]
        r.update(agree_one_card=agree, first_difference=first)
        run.log(f"{SERVE_HYBRID} over {shape} against one card (not held: "
                f"bf16 sums in another order): {100 * agree:.1f} % of the "
                f"{got.size} tokens equal; first differing step by request "
                f"{first}")
        del one, params
        _reset_peak(mesh.device)
    mesh.barrier()
    run.res["serve_hybrid"] = r


def _hold_serve(run, what, want, rec, got_tokens, caches, cfg):
    """Rank 0: the mesh serve against the one-card one (``want``: tokens,
    logits, caches on the host).  Logits of the rows still compared in
    the band; tokens equal, a step whose one-card top-2 gap lies inside
    the band leaving its row out from then on; the caches of the rows
    left in the band, positions bitwise."""
    from repro_torch.models import module as M

    w_tok, w_logits, w_caches = want
    keep = torch.ones(w_tok.shape[0], dtype=torch.bool)
    worst, ok, left_out = 0.0, True, []
    for i, (g, w) in enumerate(zip(rec.logits, w_logits)):
        if keep.any():
            e, good = close(g[keep], w[keep], SERVE_TOL)
            worst, ok = max(worst, e), ok and good
        top = w[:, 0, :cfg.vocab].topk(2).values
        band = SERVE_TOL * max(1.0, float(w.abs().max()))
        gt = g[:, 0, :cfg.vocab].argmax(-1)
        wt = w[:, 0, :cfg.vocab].argmax(-1)
        for row in torch.nonzero(keep & (gt != wt)).flatten().tolist():
            if float(top[row, 0] - top[row, 1]) <= band:
                keep[row] = False
                left_out.append((i, row))
            else:
                ok = False
    toks = all(np.array_equal(np.asarray(got_tokens)[r], w_tok[r])
               for r in range(len(keep)) if keep[r])
    cache_ok, cworst = True, 0.0
    for k, x in M.flatten(caches).items():
        y = w_caches[k]
        x, y = x.cpu()[keep], y[keep]
        if k.endswith("pos"):
            cache_ok &= torch.equal(x, y)
        else:
            e, good = close(x, y, SERVE_TOL)
            cworst, cache_ok = max(cworst, e), cache_ok and good
    run.check(ok and toks and cache_ok and bool(keep.any()),
              f"{what}: the prefill's last logits and {len(rec.logits) - 1} "
              f"decode steps' logits within rtol {SERVE_TOL}, atol "
              f"{SERVE_TOL} x max(1, max|one card|) (max |d| {worst:.3e}); "
              f"greedy tokens equal; caches gathered back in the band (max "
              f"|d| {cworst:.3e}), positions bitwise; steps left out on a "
              f"near tie (step, row): {left_out}")
    return dict(max_abs_err=worst, cache_max_abs_err=cworst,
                left_out=left_out)


def _rank_device(run) -> torch.device:
    """This rank's device (``cuda:LOCAL_RANK``, or the CPU)."""
    if run.device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def serve_check(run):
    """(b) 3: gemma2-27b and hymba-1.5b at full widths, 2 layers, float32
    activations, over (1, N), (2, 2) (N = 4) and (N, 1), each against the
    one-card ``ServeEngine`` on card 0; hymba also on prompts past its
    window (a rolled ring split over the sequence)."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    shapes = [(1, run.n)] + ([(2, 2)] if run.n == 4 else []) + [(run.n, 1)]
    out = {}
    for arch, layers, (n_req, lens, new) in SERVE_CHECK:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  dtype="float32")
        reqs = serve_requests(cfg, lens, n=n_req, new=new, seed=1)
        max_len = lens[1] + new
        rolled = cfg.window is not None and lens[0] > cfg.window
        want, dev = None, _rank_device(run)
        if run.rank == 0:
            params = M.init_params(T.param_defs(cfg), prng.PRNGKey(1), dev)
            true_fan_in_(params, cfg)
            one = ServeEngine(cfg, params, max_len=max_len, device=dev)
            rec = ServeRecorder(one, keep=True)
            toks = np.stack([q.tokens for q in one.serve(reqs)])
            want = (toks, rec.logits, {k: v.cpu() for k, v in
                                       M.flatten(rec.caches).items()})
            del one, rec, params
            _reset_peak(dev)
        for shape in shapes:
            mesh = make_test_mesh(shape, device=run.device)
            if rolled:
                seq = SH.cache_seq_axes(mesh, n_req, cfg.window)
                run.check(mesh.count(seq) > 1 or shape[1] == 1,
                          f"{arch} over {shape}: every prompt of {lens} "
                          f"tokens is past the window of {cfg.window}, so "
                          f"the local ring is rolled; its sequence splits "
                          f"{mesh.count(seq)} ways over {seq}")
            blocks = _blocks(cfg, mesh, prng.PRNGKey(1))
            true_fan_in_(blocks, cfg)
            eng = ServeEngine(cfg, blocks, max_len=max_len, mesh=mesh)
            rec = ServeRecorder(eng, keep=True)
            got = np.stack([q.tokens for q in eng.serve(reqs)])
            caches = SH.gather_caches(rec.caches, eng._layout["shards"])
            if run.rank == 0:
                out[f"{arch} {lens} {shape}"] = _hold_serve(
                    run, f"{arch} at full widths, {layers} layers, float32, "
                    f"{n_req} requests of {lens} prompt tokens, {new} tokens, "
                    f"over {shape} against one card", want, rec, got,
                    caches, cfg)
            del eng, rec, blocks, caches
            _reset_peak(mesh.device)
        run.log(f"(b) 3, {arch}, prompts {lens}: "
                f"{time.perf_counter() - t0:.1f} s")
    run.res["serve_check"] = out


MESH_JOBS = {"one": mesh_one, "cards": mesh_cards, "full": mesh_full,
             "mamba": mesh_mamba, "check": mesh_check, "pp": mesh_pp,
             "serve-one": serve_one, "serve-cards": serve_cards,
             "serve-full": serve_full, "serve-hybrid": serve_hybrid,
             "serve-check": serve_check}
#: the parts that run on one rank
ONE_RANK_JOBS = ("one", "serve-one")


def mesh_rank(rank, n, port, job, out_dir, device_type="cuda"):
    """One process of phase 15: rank ``rank`` of a world of ``n`` on
    ``cuda:rank`` (or the CPU), running ``MESH_JOBS[job]`` and writing
    its results to ``out_dir``."""
    import torch.distributed as dist

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank))
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    run = MeshRun(rank, n, "cpu" if device_type == "cpu" else None)
    MESH_JOBS[job](run)
    with open(os.path.join(out_dir, f"{job}_{rank}.json"), "w") as f:
        json.dump(run.res, f, default=float)
    dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_mesh(job: str, n: int, device_type="cuda") -> list:
    """``MESH_JOBS[job]`` on ``n`` ranks in child processes; their
    results, by rank.  A rank that raises raises here."""
    import tempfile

    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(prefix=f"smoke_mesh_{job}_")
    try:
        mp.spawn(mesh_rank, (n, free_port(), job, out, device_type),
                 nprocs=n, join=True)
        res = []
        for r in range(n):
            with open(os.path.join(out, f"{job}_{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for r in res:
        for what in r["failures"]:
            check(False, what)
    return res


def mesh_phase(dev, card, trn) -> dict:
    """Phase 15: the LM trainer over a mesh of cards."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"mesh: the smoke holds {torch.cuda.memory_allocated(dev) / 2**30:.2f}"
        f" GiB on {dev} before the ranks start")
    t0 = time.perf_counter()
    one = spawn_mesh("one", 1)[0]
    out = dict(one=one, seconds_a=time.perf_counter() - t0)
    log(f"mesh (a) on {card}: {out['seconds_a']:.1f} s")
    n = min(4, torch.cuda.device_count())
    if n < 2:
        log("mesh: one card visible; phase 15 (b) runs where there are more")
        out["cards"] = None
        return out
    t0 = time.perf_counter()
    res = spawn_mesh("cards", n)
    r0 = res[0]
    one_card = trn["full"]["tokens_per_s"]
    mm = r0["mamba"]
    share = mm["tokens_per_s"] / (n * one_card)
    log(f"mesh (b) on {n} x {card}: {MESH_ARCH} uncut {r0['full']['median_ms']:.1f}"
        f" ms a step, {r0['full']['tokens_per_s']:.1f} tokens/s, peak GiB "
        f"{[round(p, 2) for p in r0['full']['peak_gib']]}; NCCL "
        f"{r0['full'].get('nccl_ms', 0):.1f} of "
        f"{r0['full'].get('device_ms', 0):.1f} ms device time on rank 0")
    log(f"mesh (b) on {n} x {card}: {MESH_MAMBA[0]} {mm['tokens_per_s']:.1f} "
        f"tokens/s over {n} cards against {one_card:.1f} on one (phase 11 "
        f"(a)): {100 * share:.1f} % of {n}x")
    out.update(cards=n, full=r0["full"], mamba=mm, mamba_scaling=share,
               mamba_one_card_tokens_per_s=one_card, check=r0["check"],
               peaks_mamba=[r["mamba"]["peak_gib"] for r in res],
               seconds_b=time.perf_counter() - t0,
               launches=mm["launches"])
    log(f"mesh (b): {out['seconds_b']:.1f} s")
    return out


def serve_mesh_phase(dev, card) -> dict:
    """Phase 16: LM serving over a mesh of cards."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    one = spawn_mesh("serve-one", 1)[0]["serve_one"]
    out = dict(one=one, seconds_a=time.perf_counter() - t0,
               launches=one[SERVE_ONE[1][0]]["launches"],
               dense_launches=one[SERVE_ONE[0][0]]["launches"])
    log(f"serve mesh (a) on {card}: {out['seconds_a']:.1f} s")
    n = min(4, torch.cuda.device_count())
    if n < 2:
        log("serve mesh: one card visible; phase 16 (b) runs where there "
            "are more")
        out["cards"] = None
        return out
    t0 = time.perf_counter()
    res = spawn_mesh("serve-cards", n)
    r0 = res[0]
    full, hy = r0["serve_full"], r0["serve_hybrid"]
    out.update(cards=n, full=full, hybrid=hy, check=r0["serve_check"],
               hybrid_launches_by_rank=[r["serve_hybrid"]["launches"]
                                        for r in res],
               cards_launches=hy["launches"],
               dense_launches={k: v + full["launches"].get(k, 0) for k, v in
                               out["dense_launches"].items()},
               seconds_b=time.perf_counter() - t0)
    log(f"serve mesh (b) on {n} x {card}: {SERVE_FULL} uncut over "
        f"{full['mesh']}: prefill {full['prefill_tokens_per_s']:.1f} "
        f"tokens/s, decode p50 {full['decode_p50_ms']:.2f} ms, p99 "
        f"{full['decode_p99_ms']:.2f} ms, peak GiB "
        f"{[round(p, 2) for p in full['peak_gib']]}, NCCL "
        f"{full.get('nccl_ms', 0):.2f} of {full.get('profile_device_ms', 0):.2f}"
        f" ms device time in a decode step on rank 0; {SERVE_HYBRID} over "
        f"{hy['mesh']}: {hy['prefill_tokens_per_s']:.1f} tokens/s, decode "
        f"p50 {hy['decode_p50_ms']:.2f} ms; {out['seconds_b']:.1f} s")
    return out


# ------------------------------------ phase 17: capacity and roofline

def _prompt(r) -> int:
    """The left-padded prompt length of a served batch's prefill."""
    return round(r["prefill_tokens_per_s"] * r["prefill_ms"] / 1e3
                 / LM_REQUESTS)


def capacity_cases(trn=None, dense=None, mesh_full=None, serve_full=None
                   ) -> list:
    """Phase 17's cases, from the records of phase 11 (a) ``trn``, 12 (a)
    ``dense``, and ``(n, record)`` of 15 (b) 1 and 16 (b) 1: (phase,
    arch, mesh dims, kind, (seq, batch or cache length), measured ms,
    measured peak GiB by card)."""
    max_len = LM_PROMPT[1] + LM_NEW_TOKENS
    cases = []
    if trn is not None:
        cases.append(("11 (a)", LM_ARCH, (1, 1), "train",
                      (TRAIN_SEQ, TRAIN_BATCH), trn["full"]["median_ms"],
                      [trn["full"]["peak_gib"]]))
    if dense is not None:
        q = dense["served"][DENSE_ARCH]
        cases.append(("12 (a)", DENSE_ARCH, (1, 1), "serve",
                      (_prompt(q), max_len), q["prefill_ms"], [q["peak_gib"]]))
    if mesh_full is not None:
        n, r = mesh_full
        cases.append(("15 (b) 1", MESH_ARCH, (n, 1), "train",
                      (MESH_FULL[1], MESH_FULL[0]), r["median_ms"],
                      r["peak_gib"]))
    if serve_full is not None:
        n, r = serve_full
        cases.append(("16 (b) 1", SERVE_FULL, (1, n), "serve",
                      (_prompt(r), max_len), r["prefill_ms"], r["peak_gib"]))
    return cases


def capacity_phase(card, cases) -> dict:
    """Phase 17: the dry run's capacity model and roofline against what
    ``cases`` (``capacity_cases``) measured in this call (nothing runs on
    the card)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.hw.constants import H100_SXM
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as R

    out = {}
    for phase, arch, dims, kind, (seq, other), ms, peaks in cases:
        cfg = get_config(arch)
        am = D.AbstractMesh(("data", "model"), dims)
        cards = dims[0] * dims[1]
        if kind == "train":
            cap = D.static_capacity_model(
                cfg, ShapeSpec(phase, seq, other, "train"), am)
            work = ShapeSpec(phase, seq, other, "train")
            what = "step"
        else:   # the engine's caches hold max_len positions
            cap = D.static_capacity_model(
                cfg, ShapeSpec(phase, other, LM_REQUESTS, "decode"), am)
            work = ShapeSpec(phase, seq, LM_REQUESTS, "prefill")
            what = "prefill"
        persistent = sum(cap.get(k, 0) for k in
                         ("params", "opt_state", "grad_accum", "kv_cache"))
        peak = max(peaks) * 2**30
        mf = R.model_flops(cfg, work)
        terms = R.roofline_terms(mf / cards, persistent, 0.0, cards)
        bound_share = terms["step_time_lb_s"] / (ms / 1e3)
        useful = R.roofline_fraction(mf, cards, ms / 1e3)
        out[phase] = dict(arch=arch, mesh=list(dims), kind=kind,
                          capacity={k: float(v) for k, v in cap.items()},
                          persistent_gib=persistent / 2**30,
                          measured_peak_gib=peak / 2**30,
                          model_flops=mf, bound_ms=1e3 * terms[
                              "step_time_lb_s"], bound_by=terms["bottleneck"],
                          measured_ms=ms, bound_share=bound_share,
                          useful_flop_share=useful)
        log(f"capacity {phase} {arch} over {dims} on {card}: persistent "
            f"{persistent / 2**30:.2f} GiB predicted ("
            f"{ {k: round(v / 2**30, 2) for k, v in cap.items()} } GiB) "
            f"against a measured peak of {peak / 2**30:.2f} GiB a card")
        log(f"roofline {phase} {arch}: {what} bound {1e3 * terms['step_time_lb_s']:.1f}"
            f" ms ({terms['bottleneck']}; {mf:.3e} useful FLOPs over "
            f"{cards} x {H100_SXM.peak_flops_bf16:.3g} FLOP/s) against "
            f"{ms:.1f} ms measured: bound {100 * bound_share:.2f} %, useful "
            f"FLOPs {100 * useful:.2f} % of the card's bf16 peak")
        check(persistent <= peak,
              f"capacity {phase} {arch}: the persistent state "
              f"{persistent / 2**30:.2f} GiB <= the measured peak "
              f"{peak / 2**30:.2f} GiB")
        check(bound_share <= 1.0 and useful <= 1.0,
              f"roofline {phase} {arch}: no share over 100 % (bound "
              f"{100 * bound_share:.2f} %, useful {100 * useful:.2f} %)")
    return out


def mesh_parts(parts, card) -> int:
    """``--mesh``: only the named parts of phases 15 and 16, each on its
    ranks; 0 when every check passed."""
    unknown = sorted(set(parts) - set(MESH_JOBS))
    if unknown:
        log(f"chip_smoke: no part {unknown} of phases 15 and 16; the parts are "
            f"{sorted(MESH_JOBS)}")
        return 2
    n = min(4, torch.cuda.device_count())
    done = {}
    for part in parts:
        ranks = 1 if part in ONE_RANK_JOBS else n
        t0 = time.perf_counter()
        res = spawn_mesh(part, ranks)
        log(f"mesh {part} on {ranks} x {card}: "
            f"{time.perf_counter() - t0:.1f} s")
        log(json.dumps({part: res[0]}, default=float))
        done[part] = (ranks, res[0])
    # phase 17's cases of the parts that ran on several cards
    full = done.get("full") or done.get("cards")
    serve = done.get("serve-full") or done.get("serve-cards")
    cases = capacity_cases(
        mesh_full=(full[0], full[1]["full"]) if full and full[0] > 1 else None,
        serve_full=((serve[0], serve[1]["serve_full"])
                    if serve and serve[0] > 1 else None))
    if cases:
        capacity_phase(card, cases)
    for f in FAILURES:
        log(f"  failed: {f}")
    return 1 if FAILURES else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prev", type=Path, default=None,
                    help="root of another checkout (e.g. the parent "
                    "commit's tree): time its stcf_support and "
                    "chunk_scatter in turns with this tree's")
    ap.add_argument("--mesh", default=None, metavar="PART[,PART...]",
                    help="run only these parts of phases 15 and 16 (one, "
                    "full, mamba, check, pp; serve-one, serve-full, "
                    "serve-hybrid, serve-check) and exit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repro_torch sources are not beside "
              f"{Path(__file__).name}; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import platform
    from repro_torch.core import time_surface as ts
    from repro_torch.events import aer, datasets, pipeline
    from repro_torch.kernels import _lib, ops
    from repro_torch.serve import spec as rs
    from repro_torch.serve import ts_engine as eng

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"card: {card}; torch.cuda.get_device_name: "
        f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}; "
        f"platform.describe: {platform.describe()}")
    if args.mesh:
        return mesh_parts(args.mesh.split(","), card)

    t0 = time.perf_counter()
    _, info = _lib.library()
    log(f"build: {info.seconds:.2f} s compile+link, "
        f"{time.perf_counter() - t0:.2f} s to load -> {info.path}")
    for line in info.ptxas.splitlines():
        if "Used" in line or "Compiling entry" in line or line.startswith("=="):
            log(f"  {line.strip()}")

    t0 = time.perf_counter()
    words = make_scenes(datasets, aer)
    log(f"data: {N_SCENES} scenes x {2 * DEADLINES} bursts, "
        f"{sum(len(w) for s in words for w in s)} events, "
        f"{time.perf_counter() - t0:.2f} s")
    mods = (_lib, ops, ts, aer, pipeline, rs, eng)
    phase_s = {}
    t0 = time.perf_counter()
    run = run_engine(dev, mods, words, card)
    prev = None if args.prev is None else build_prev(args.prev.resolve())
    rows = kernel_phase(dev, mods, words, run, prev)
    torch.cuda.synchronize()
    phase_s["time surface"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loops = shard_loops(dev, mods, words, run, card)
    phase_s["shards"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_runs = (card_loops(dev, mods, words, run, card)
                 if torch.cuda.device_count() > 1 else None)
    run.pop("step_outs")   # phase 1's products are not needed any more
    phase_s["cards"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = run_lm(dev, card)
    phase_s["lm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows += decay_scan_phase(dev, lm)
    torch.cuda.synchronize()
    phase_s["decay_scan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hd = run_heads(dev, mods, words, card, Timer(dev))
    torch.cuda.synchronize()
    phase_s["heads and labels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    an = analog_phase(dev, mods, words, card, Timer(dev), rows)
    sm = stream_phase(dev, mods, words, card)
    torch.cuda.synchronize()
    phase_s["analog and stream"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sw = sweep_phase(card)
    phase_s["sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    feeds, fl = fleet_phase(dev, mods, words, card, sm)
    torch.cuda.synchronize()
    phase_s["fleet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sh = shard_phase(dev, mods, words, card, loops, fl, feeds)
    torch.cuda.synchronize()
    phase_s["shards"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    if card_runs is None:
        log("cards: one card visible; phase 9 runs where there are more")
        cd = None
    else:
        cd = cards_phase(dev, mods, words, card, card_runs, feeds, smi)
    phase_s["cards"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    vis = vision_phase(dev, card)
    torch.cuda.synchronize()
    phase_s["vision training"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trn = train_phase(dev, card)
    torch.cuda.synchronize()
    phase_s["lm training"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = dense_phase(dev, card)
    torch.cuda.synchronize()
    phase_s["dense lm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hybrid = hybrid_phase(dev, card)
    torch.cuda.synchronize()
    phase_s["hybrid and moe lm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    left = leftovers_phase(dev, mods, card)
    torch.cuda.synchronize()
    phase_s["paper-facing leftovers"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = mesh_phase(dev, card, trn)
    phase_s["lm mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    smesh = serve_mesh_phase(dev, card)
    phase_s["lm serving mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cap = capacity_phase(card, capacity_cases(
        trn, dense, (mesh["cards"], mesh["full"]) if mesh["cards"] else None,
        (smesh["cards"], smesh["full"]) if smesh["cards"] else None))
    phase_s["capacity and roofline"] = time.perf_counter() - t0
    log(f"phases, s: { {k: round(v, 2) for k, v in phase_s.items()} }")
    log(json.dumps({"analog": an, "stream": sm, "sweep": sw, "fleet": fl,
                    "shards": sh, "cards": cd, "vision": vis,
                    "training": {**trn, "full": {
                        k: v for k, v in trn["full"].items()
                        if k != "launches"}}, "dense": dense,
                    "hybrid": hybrid, "leftovers": left, "mesh": mesh,
                    "serve_mesh": smesh, "capacity": cap},
                   default=str))

    launches = {**run["launches"], "decay_scan": lm["launches"]["decay_scan"]}
    kernels = []
    for row in rows:
        name = row.pop("name")
        kernels.append(dict(name=name, route="cuda", source=SOURCES[name],
                            replaces=REPLACES[name],
                            launches=launches[name],
                            heads_path_launches=hd["launches"].get(name, 0),
                            stream_path_launches=sm["launches"].get(name, 0),
                            fleet_path_launches=fl["launches"].get(name, 0),
                            shard_path_launches=sh["launches"].get(name, 0),
                            shard_path_launches_per_shard=[
                                per.get(name, 0)
                                for per in sh["launches_per_shard"]],
                            dense_path_launches=sum(
                                r["launches"].get(name, 0)
                                for r in dense["served"].values()),
                            hybrid_path_launches=hybrid["hybrid"][
                                "launches"].get(name, 0),
                            moe_path_launches=hybrid["moe"][
                                "launches"].get(name, 0),
                            examples_path_launches=left["examples"][
                                "launches"].get(name, 0),
                            isc_qvga_path_launches=left["isc_qvga"][
                                "launches"].get(name, 0),
                            mesh_path_launches=mesh.get("launches", {}).get(
                                name, 0),
                            serve_mesh_path_launches=smesh["launches"].get(
                                name, 0),
                            serve_mesh_cards_path_launches=(
                                smesh["cards_launches"].get(name, 0)
                                if smesh["cards"] else None),
                            serve_mesh_dense_path_launches=smesh[
                                "dense_launches"].get(name, 0),
                            kernel_ms=row["ms"], **row))
        if name == "decay_scan":
            hs = hybrid["decay_scan"]
            kernels[-1].update(
                train_path_launches=trn["full"]["launches"]["decay_scan"],
                train_path_backward_launches=trn["full"]["launches"][
                    "decay_scan_bwd"],
                hybrid_shape=hs["shape"], hybrid_ms=hs["ms"],
                hybrid_plain_ms=hs["plain_ms"],
                hybrid_bound_ms=hs["bound_ms"],
                hybrid_max_abs_err=hs["max_abs_err"],
                mesh_path_backward_launches=mesh.get("launches", {}).get(
                    "decay_scan_bwd", 0))
    log(json.dumps({"kernels": kernels}))
    if FAILURES:
        log(f"chip_smoke: {len(FAILURES)} check(s) failed:")
        for f in FAILURES:
            log(f"  {f}")
        return 1
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
