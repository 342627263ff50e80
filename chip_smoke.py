#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

  1. device    — require a CUDA device, print the card's name and power
                 limit, turn TF32 off;
  2. build     — compile every CUDA source of src/repro_torch/kernels/csrc
                 (one nvcc per source, all at once) into one library under
                 build/kernels/, for sm_90a; print each kernel's registers,
                 static shared memory and spills (ptxas -v), and fail unless
                 the SASS of the flash, paged-decode, paged-prefill,
                 grouped-matmul and the SSD scan's state and chunk kernels,
                 and of the backward's flash dq and dk/dv and SSD chunk
                 kernels, holds tensor-core (HMMA) instructions (cuobjdump
                 -sass);
  3. kernels   — hold each of the five kernels against its plain PyTorch
                 version on the card and time the kernel, the plain version
                 and a library yardstick the port never calls (each launch
                 behind an L2 flush): the paged kernels at qwen2-0.5b's serve
                 shapes (f32 and bf16, window 0 and 5, an all -1 table row;
                 torch's scaled_dot_product_attention on the gathered K/V),
                 then the paged decode and prefill at every split width
                 (1, 2, 4, 8, 16 and 64 table columns a split; f32 timed, f32
                 and bf16 with an all -1 row checked) at the engine's
                 positions and at a long context (positions near 1000, the
                 table full at MB 64), each beside SDPA; the paged decode
                 and prefill at the olmoe-1b-7b and phi-3-vision-4.2b paged
                 engines' shapes (16/16 heads of 128 and 32/32 heads of 96,
                 G 1), at the chaos phase's (14/2 heads of 64, MB 16, a
                 96-block pool, decode B 8 and prefill [4, 16] at positions
                 32-96), at one sharded rank's (7/1 heads of 64, G 7, MB
                 64, the engine's 512-block pool, positions 192-384), at
                 one 'data' rank's (14/2 heads, decode W 4, prefill [2,
                 16], the same pool and positions) and
                 at the gemma3-27b engine's (32/16 heads of 128, G 2, MB
                 96, a 384-block pool, positions 960-1432 across its 1024
                 window); f32 and bf16, window 0 and 5 (gemma3: 0 and
                 1024), an all -1 row; the f32 window-0 call (gemma3: bf16
                 at window 1024) timed beside its plain version, SDPA and
                 its bound);
                 flash attention at olmoe-1b-7b's prefill shape
                 ([1, S, 16, 128], S 128 and 256, causal), at
                 phi-3-vision-4.2b's forward shape ([1, 1024, 32, 96],
                 causal, timed) and its synergy probe's ([2, 1024, 32, 96],
                 causal, timed) and at edge shapes (14/2 heads at D 64,
                 window 5, non-causal, ragged S 200, D 96 with window 5),
                 f32 and bf16 (scaled_dot_product_attention); grouped matmul
                 at olmoe-1b-7b's expert shapes (64 experts x 40 rows, gate-up
                 2048 x 2048 and down 1024 x 2048) with valid_rows None,
                 random and partly zero, f32 and bf16, each all-valid case
                 timed beside torch.bmm; the SSD
                 scan at mamba2-780m's forward shape ([2, 4096] tokens, 48
                 heads of 64, state 128, chunk 256), at zamba2-7b's ([1,
                 4096], 112 heads of 64, state 64, chunk 256), at a
                 mamba2-780m rank's of the sharded phase's (1, 2) forward
                 ([1, 512], 24 heads, timed), the smoke widths, a chunk
                 that halves (S 96), S 64 with chunk 128, a_log = -40
                 (memoryless) and B = H = 1 (tolerance 5e-4;
                 no PyTorch call computes it, so no library time), the
                 mamba2 time printed beside the SIMT kernel's it replaced;
                 flash also at whisper-large-v3's decoder shape ([1, 448,
                 20, 64], causal, G 1, a partial row tile), timed beside
                 its bound and SDPA; then the two backward kernels (no TPU
                 kernel has one; tensor cores, three TF32 passes for f32,
                 one bf16 pass for bf16), through
                 the autograd Functions of
                 ops.flash_attention and ops.ssd_scan, against autograd of
                 the plain versions (each gradient's largest error over its
                 largest value: 2e-5 for flash in f32 and 2e-2 in bf16,
                 against the plain version on the bf16 inputs upcast to
                 f32; 5e-4 for the SSD scan):
                 flash in f32 and in bf16 at phi-3-vision-4.2b's train step
                 ([2, 1024, 32, 96]), olmoe-1b-7b's [1, 256, 16, 128] and
                 whisper-large-v3's [1, 448, 20, 64], each timed beside its
                 bound, the plain backward and SDPA's forward +
                 autograd.grad in the same dtype, a GQA / window / ragged-S
                 edge and D 128 with GQA 16/4 and a window; the SSD scan at
                 mamba2-780m's
                 train step ([2, 4096, 48, 64], N 128) and zamba2-7b's ([1,
                 4096, 112, 64], N 64), timed beside the bound and the
                 plain backward (no library time), the smoke widths and a
                 chunk that halves, and torch.profiler's count of one
                 backward call at mamba2's shape (three launches: the
                 reversed states, their pass, the fused chunk pass; no
                 ssd_scan_chunk_kernel); then the paged decode (W 8) and
                 prefill ([4, 16]) in their partial mode at the kv-seq
                 rank shape (14 / 2 heads of 64; 16-position blocks split
                 over 4 ranks, local block 4 at offsets 0, 4, 8 and 12;
                 MB 64, positions 192-384; f32 and bf16, windows 0 and 5,
                 an all -1 row), each slice as a strided view of the pool
                 and as a local pool, output and row log-sum-exp against
                 the plain version, the four partials merged against one
                 whole-pool call; and flash with a query offset (q [1, 64,
                 14, 64] at 192 over 256 keys of 2 KV heads; the four row
                 blocks of a 256-token pass gathered against one
                 self-attention call); each f32 call timed beside its
                 plain version, SDPA (on the gathered local K/V, or with
                 the explicit mask) and its bound;
  4. reference — the paged prefill + decode path (qwen2-0.5b smoke), the
                 MoE one-pass forward + contiguous decode steps
                 (olmoe-1b-7b smoke), the mamba2 forward + decode chain
                 (mamba2-780m smoke), the zamba2 forward + decode chain
                 (zamba2-7b smoke at 2 and at 5 Mamba2 blocks) and the
                 whisper forward, prefill_cross_kv + decode chain
                 (whisper-large-v3 smoke, 37 tokens) on the card against
                 the same paths on the CPU (plain versions, which the CPU
                 tests hold against the JAX package); each decode chain
                 also against its forward's logits (2e-3);
  5. engine    — the full-width qwen2-0.5b paged engine (12 of its 24
                 layers, random weights from a seed) built by repro_torch.launch.serve's own
                 build function: 16 requests of 128-256 tokens after a shared
                 64-token prefix, 64 new tokens each, 8 slots, 4 prefill
                 lanes, decode horizon 8, block 16, max_len 1024, float32.
                 Every engine phase serves its request set three times on
                 one engine, every launch counter set to 0 before each run:
                 "captured" (each static signature's first call eager, then
                 captured as a CUDA graph; the main path's run, whose
                 launches the kernels line reads), "eager" (under
                 graphs.eager(): no graph) and "replayed" (graphs only);
                 the three must agree in tokens, every ServeStats counter
                 and every launch count, and each prints decode ms a step,
                 prefill ms a dispatch and a prompt token, and tokens/s.
                 Both paged kernels must launch and the plain versions must
                 not run; decode horizons and prefill rounds must be graphs;
  6. profile   — torch.profiler over the same request set on the same
                 engine, replayed and eager: device busy share (of the
                 profiled run's wall clock and of the unprofiled run's of
                 phase 5: the profiler slows the host) and device time by
                 kernel. Each profiled run zeroes the launch counters first
                 and fails unless the profiler saw as many events of each
                 hand-written kernel (and of the paged merge) as the
                 counters imply: under replay that is what shows the
                 graphs ran the kernels. A marker kernel ends each window
                 and must be seen (events lost at the end of a window
                 would go unnoticed otherwise). The profiler loses events
                 now and then: a window that lost any is printed as
                 discarded and the run profiled again, four times at most;
     sampled   — a second qwen2 engine at temperature 0.8, top-k 50: 8
                 requests of 128-256 tokens after the prefix, 16 new
                 tokens, served three times (capture, then replays), which
                 must draw the same tokens; between its replays the greedy
                 engine serves the same set, and the prefill ms a round and
                 decode ms a step of both print;
      chaos     — the engine phase's qwen2-0.5b weights on a paged engine
                 of 8 slots, block 16, max_len 256, horizon 8, 4 lanes and
                 48 blocks: 24 Philly requests (+4 burst) for two tenants
                 in SLO-slack order under an allocation, all eight fault
                 kinds and an elastic controller, two growths of the pool
                 (48 -> 88 -> 96 blocks). Three runs as in phase 5, every
                 counter 0 before each: they must agree in tokens, faults,
                 drops and causes, every ServeStats counter and launch
                 count, the pool auditing clean; both paged kernels must
                 launch, the plain versions never. Each run ends with a
                 grown pool, so the next starts from a new pool and no
                 graph: the "replayed" run recaptures its signatures and
                 its figures are a recapture run's. The captured run holds
                 each growth's new pools against the old ones (torch.equal
                 on the leading slice, outside the migration's timer).
                 Then run_replay(verify=True) against the fault-free K=1
                 static contiguous engine on the same weights, and the set
                 without faults on a second engine, captured then replayed;
      obs       — the engine phase's engine and request set again, built by
                 repro_torch.launch.serve's build with --trace, --profile
                 and --profile-store (an event Tracer, a DispatchProfiler
                 with the H100's roofline, a ProfileStore): served captured,
                 replayed, then three rounds of replayed runs with both,
                 neither, the profiler alone and the tracer alone attached,
                 each round's order rotated, every counter 0 before each
                 run. The traced
                 runs must give the untraced runs' tokens, ServeStats
                 counters and paged-kernel launches (non-zero); their events
                 must pass validate_events, hold one decode_horizon event a
                 decode dispatch and one prefill_round event a prefill
                 dispatch; the profiler must hold one record a dispatch,
                 every execute record with 0 < util <= 1.05 (a dispatch
                 timed short of its own byte floor would show above it);
                 the replayed run's events, times and compile flags
                 dropped, must equal the captured run's. The Chrome trace
                 (build/obs/) must load as JSON with a track for each span
                 type and a util counter a phase, the trace report must run
                 over the JSONL dump. Prints per run and phase the
                 dispatches, compile and execute seconds and mean util, the
                 store's rate fit, profile_class(store=)'s source and
                 constants, and each setting's tokens/s: the runs, their
                 median and spread, and the median against neither's. Then the
                 chaos set with a tracer, graphs and eager: the fault,
                 recovery, admission, preemption, eviction, deferral,
                 migration and scale events must be equal between the two
                 and the tokens and launches equal the chaos phase's;
      sharded   — qwen2-0.5b served TP/DP-sharded (serve/sharded.py) by two
                 rank processes on the one card (torch.multiprocessing
                 spawn, a gloo group: NCCL refuses two ranks on one device;
                 both ranks on cuda:0, each drawing the engine phase's
                 seeded weights and keeping its own blocks; the plan's
                 programs run eager, gloo collectives cannot be captured).
                 First mesh (1, 2) at full width and the engine phase's
                 12 layers: each rank holds 7 of the
                 14 q heads and 1 of the 2 KV heads, half the vocabulary
                 and half of every MLP, and serves the engine phase's
                 paged request set cut to 8 requests and 32 new tokens;
                 then mesh (2, 1) at full width with staggered arrivals
                 (2 a step): the paged engine (the pool whole on each
                 rank; decode buckets and prefill rounds whose width 2
                 divides split over 'data', each rank's new K/V gathered
                 and written on both), and the contiguous engine on
                 prompts of 64-256 tokens (each rank holds 4 of the 8
                 slots and decodes the bucket rows of its own slots; every
                 prompt prefills on both ranks, through plain mha as the
                 dense forward attends, and is stored by its slot's rank).
                 Both ranks' tokens must equal each other and a
                 single-process eager run of the same engine on the same
                 weights in this process; each paged rank must launch
                 both paged kernels, no rank a plain version; the paged
                 data run must save decode rows and split prefill rounds.
                 Then four rank processes on mesh (1,
                 4), where 'model' divides neither the 14 q heads nor the
                 2 KV heads: the attention leaves split flat and the
                 pools' positions over 'model' (nothing held whole), at
                 full width and 6 of the 24 layers the paged engine on
                 the same request set (a
                 rank holds 4 of every block's 16 offsets; decode and
                 prefill chunks run kv-seq: the paged kernels' partial
                 mode, merge_partials), and the contiguous engine at 4
                 layers on prompts whose lengths 4 divides (each prefill
                 q-seq through flash with a query offset, decode kv-seq
                 over a rank's quarter of max_len); every rank's tokens
                 equal the single-process run's, the partial kernels
                 (paged) or flash with an offset (contiguous) launch on
                 every rank, no plain call. In the two-rank group, after
                 the qwen2 runs, the recurrent families tensor-parallel on
                 mesh (1, 2) (serve/sharded.py, models/mamba2.py): the
                 fused in_proj split flat, the conv over its channels, the
                 SSM states over their heads, the K/V by head:
                 mamba2-780m at full width and 12 of its 48 layers (a
                 rank holds 24 of the 48 SSM heads), zamba2-7b at full
                 width and 6 of its 81 Mamba2 blocks (one shared-block
                 call), whisper-large-v3 at full width and 2 of its 32
                 decoder layers, each on 4 slots serving 6 requests of 8-16
                 prompt tokens and 4-12 new ones, and mamba2-780m at full
                 width and 24 of its 48 layers on mesh (2, 1) (2 of the 4 slots' states
                 a rank, each bucket row stepped at its slot's rank);
                 every rank's tokens
                 equal the single-process eager run's, collectives issued
                 through gloo, programs eager, nothing held whole, no
                 kernel and no plain version launched (serving steps the
                 decode, as in the reference); then mamba2-780m's forward
                 on [1, 512] tokens under the (1, 2) rules: the SSD kernel
                 once a layer a rank at 24 heads, no plain version, logits
                 within 3e-4 of the largest |logit| of the single-process
                 forward (printed beside that forward's own gap when only
                 the scan's rounding changes). No rank of any run holds a
                 leaf whole where the reference splits it; a contiguous
                 run's pool holds n_slots / d slots a rank over 'data' d;
                 each rank prints its pool leaves' shapes and bytes and
                 the decode rows, their tokens and the prefill lanes it
                 computed as its part and whole, which summed over the
                 'data' ranks (the whole ones once) must give the
                 single-process run's tokens and lanes and the host loop's
                 rows. Prints the collective counts by kind and the share
                 of the wall spent in them, ms a decode step sharded and
                 single-process, and the phase's seconds. A rank that
                 fails fails the phase;
 7. olmoe     — with the qwen2 engines freed, the full-width olmoe-1b-7b
                 contiguous engine (64 experts top-8) cut to 4 of its 16
                 layers (float32 weights from a seed; 16 until the gemma3
                 phase came, then 8), its three runs as in phase 5:
                 8 requests of 64-128 tokens, 64 new tokens each, 4 slots,
                 decode horizon 8, max_len 256. Every layer of every prefill
                 (eager: each prompt at its exact length) must launch the
                 flash kernel (8 x prefills launches) and its plain version
                 must not run. The grouped matmul is an op no model calls
                 (the MoE layer contracts with einsum, as the JAX package's
                 does): it launches 0 times on both paths. Then the profile
                 of phase 6 over the same requests;
  8. olmoe paged — the full-width olmoe-1b-7b paged engine on the same
                 weights (4 layers): 8 requests of 64-128 tokens after a
                 shared 32-token prefix (two full blocks), 64 new tokens
                 each, 4 slots, 4 prefill lanes, horizon 8, block 16,
                 max_len 256;
                 its three runs as in phase 5 (both paged kernels, no plain
                 version, no flash), one profiled replayed run; then the
                 prefix cache against cold runs: gated at one slot and one
                 lane (16 new tokens; the same shapes in both runs), where
                 a block-aligned hit that resumes the expert counts must
                 give the cold tokens bit for bit, and reported at the
                 phase's 4 slots (another schedule: tokens may part at
                 near-ties of f32 logits); then each prompt's first-step
                 logits, chunked through the paged prefill, against a one-pass
                 forward (the contiguous engine's prefill): first-token
                 agreement and the largest logit gap, reported, not gated;
  9. phi-3-vision — with the olmoe engines freed, full-width
                 phi-3-vision-4.2b (32 layers, d_model 3072, 32 heads of 96,
                 ~4.2 B float32 weights from a seed): Model.forward on
                 [1, 1024] tokens with [1, 576, 3072] patch embeddings
                 (flash in all 32 layers, its plain version never) against
                 the same forward with the plain version in the kernel's
                 place (1e-3), Model.loss; then its paged engine on the same
                 weights (text-only, as in the reference): 8 requests of
                 128-256 tokens, 32 new tokens each, 4 slots, 4 lanes,
                 horizon 8, block 16, max_len 512, its three runs and a
                 profiled replayed run as in phase 8;
     synergy   — with the phase's weights freed, one Trainer of
                 phi-3-vision-4.2b at full width, 8 of its 32 layers (32
                 until the gemma3 phase came, then 16), with remat "full"
                 (seeded f32 weights, gradients and AdamW moments), and the Synergy optimistic profiler
                 (repro_torch.core.profiler, the paper's ServerSpec and the
                 default ProfilerConfig) live on the card for a 1-GPU
                 phi-3-vision-4.2b job of resnet18's workload class (image,
                 saturating at 9 CPUs a GPU). Each probe at c CPUs builds a
                 DataPipeline of c workers ("scaled") with the cache holding
                 the whole dataset, pulls batches of [2, 1024] tokens
                 through a SynergyIterator, adds [2, 576, 3072] stub patch
                 embeddings on the host, and runs Trainer.train_step on the
                 card, as the reference runtime's _measure_rate does (a
                 warm-up, then 2 steps timed on CUDA events from the
                 warm-up's end; reading each step's loss syncs). The
                 preprocessing cost is set so one worker takes 9 measured
                 train steps a batch. Fails unless there are at most
                 ceil(log2(24)) + 2 probes, each launching flash 32 times a
                 step (16 forward, 16 recomputed) and its backward 16 times
                 and the plain version never, the trainer takes one step a
                 call, every rate, loss and gradient norm is finite and the
                 rates above 0, W is [24, 12],
                 the knee demand reaches the GPU-proportional rate, a lease
                 sent mid-stream shows on the next batch (workers and cache
                 capacity), a termination stops the iteration and calls
                 on_terminate once, and one progress message arrives a
                 batch. Prints the probed curve, the knee, the rate at the
                 proportional share (3 CPUs, 62.5 GB) and the probes' wall
                 seconds beside the profiler's accounting. Then the
                 simulator on the card's host: 16 servers (128 GPUs), a
                 300-job Philly trace (seed 7, 12 jobs an hour) under SRTF
                 for proportional, greedy, tune and tune_split, and
                 Synergy-OPT on 4 servers and 40 jobs; every job must
                 finish and tune keep within 3% of proportional's average
                 JCT and 5% of its makespan;
     train-bf16 — phi-3-vision-4.2b in bf16 (dtype and param_dtype, the
                 dry-run's train overrides) at full width and depth (32
                 layers, d_model 3072, 32 heads of 96, 3.82 B parameters,
                 7.6 GB of weights from a seed), remat "full", on [2, 1024]
                 tokens with [2, 576, 3072] patch embeddings (bf16 values):
                 first one forward and backward against the same step in
                 f32 on the same values (the f32 weights the bf16 ones
                 upcast, full depth), both through the flash kernels
                 (forward 64 launches, backward 32, plain 0); fails unless
                 the losses agree within 1e-2 relative and every leaf's
                 gradient cosine is at least 0.99 (the gap and the lowest
                 cosine printed). Then a Trainer (AdamW, lr 3e-4 after a
                 one-step warm-up) takes a warm step and 4 timed steps on
                 that batch; fails unless flash launches 64 times a step
                 (forward and recomputed) and its bf16 backward 32 times,
                 the plain version never, the params stay bf16 and every
                 loss and gradient norm is finite, and the loss falls.
                 Prints ms a step, tokens/s, the peak memory and the
                 losses;
 10. mamba2    — with the phi-3-vision engine freed, full-width
                 mamba2-780m (48 layers, d_model 1536, 48 SSM heads of 64, state 128, ~780 M
                 float32 weights from a seed): Model.forward and Model.loss
                 on [2, 4096] random tokens, each launching the SSD kernel
                 exactly 48 times (its plain version never), then 256
                 recurrent decode steps on a [1, 256] prefix against the
                 forward's logits there (2e-3), then torch.profiler over one
                 more forward;
 11. mamba2 engine — the full-width mamba2-780m contiguous engine at 12 of
                 its 48 layers (48 until the train-bf16 phase came, then
                 24), its three
                 runs as in phase 5: 4 requests of 64-128 tokens, 32 new
                 tokens each, 4 slots, decode horizon 8, max_len 256 (8
                 requests until the sharded phase came: the script keeps
                 to its time). Its prefill replays one captured batch-1
                 decode step per prompt token, so the SSD kernel launches 0
                 times here, as in the reference. Then the profile of
                 phase 6 over the same requests (~500 kernel launches a
                 step at 12 layers);
 11b. train    — launch/train.py's build_cfg("mamba2-780m", "full") with
                 remat "full" (the CLI has no remat flag, as the reference's
                 has none) and a DataPipeline of one batch of [2, 4096]
                 tokens into Trainer.fit for 8 AdamW steps (the same seeded
                 weights). First one step's loss, gradient norm (1e-4) and
                 64 gradient entries a leaf (1e-3 of the largest) against
                 the same step with the scan's plain version. Fails unless
                 every loss and gradient norm is finite, the loss falls,
                 the SSD kernel launches 96 times a step (48 forward, 48
                 recomputed) and its backward 48 times, the plain version
                 never. Prints ms a step, tokens/s and the peak memory.
                 Then python -m repro_torch.launch.train --arch mamba2-780m
                 --preset 25m --steps 20 --ckpt build/train/... on the card,
                 its checkpoint restored into a Trainer leaf for leaf, and
                 the same command again, which must resume at step 20;
     runtime  — repro_torch.core.runtime.LiveRuntime on the card as the
                 reference runs it: one ServerSpec(gpus=2, cpus=6, mem=4)
                 server, SRTF and tune, three 1-GPU smoke-width jobs
                 (qwen2-0.5b 24 iterations, mamba2-780m 32 through the SSD
                 kernels, phi-3-vision-4.2b 40 through the flash kernels),
                 each profiled live with train steps; a first run of one
                 0.5 s round, whose drain terminates the running leases
                 (each checkpoints), then 2 s rounds to the end. Fails
                 unless every job finishes at its total_iters, a terminated
                 lease resumed at the step it saved (and every resume at a
                 saved step), the four kernels launched and the plain
                 versions never (the counters are not atomic across the
                 job threads: some and none). Prints avg and p99 JCT and
                 the makespan;
 12. zamba2    — with the mamba2 engine freed, full-width zamba2-7b (81
                 Mamba2 blocks, d_model 3584, 112 SSM heads of 64, state
                 64, one shared attention block of 32 heads of 112 called
                 13 times, ~6.75 B float32 weights from a seed):
                 Model.forward and Model.loss on [1, 4096] random tokens,
                 each launching the SSD kernel exactly 81 times (its plain
                 version never); the forward again with the scan's plain
                 version on the card; 128 decode steps against both
                 forwards' logits (held to 2e-3 against the kernel's);
     zamba2 engine — its contiguous engine on the same weights cut to 15
                 of the 81 Mamba2 blocks (2 shared-block calls and the 3
                 trailing blocks; 81 until the gemma3 phase came, then
                 27), three
                 runs as in phase 5 (8 requests of 32-64 tokens, 32 new
                 tokens each, 4 slots, horizon 8, max_len 256; the prefill
                 replays a captured batch-1 decode step a token, so the
                 SSD kernel launches 0 times) and a profiled replayed run;
 13. whisper   — with zamba2 freed, full-width whisper-large-v3 (32 encoder
                 and 32 decoder layers, d_model 1280, 20 heads of 64,
                 vocab 51866, ~2.0 B float32 weights from a seed):
                 Model.forward and Model.loss on [1, 1500, 1280] frames and
                 [1, 448] tokens, each launching flash exactly 32 times
                 (the decoder's causal self-attention; the encoder and the
                 cross attention run plain mha, as in the reference), the
                 forward again with flash's plain version, then
                 prefill_cross_kv and 64 decode steps against both (2e-3);
     whisper engine — its contiguous engine on the same weights, cut to 8
                 of the 32 decoder layers (32 until the gemma3 phase came,
                 then 16),
                 text only as in the reference (cross K/V zero), the
                 zamba2 engine's
                 request set at max_len 448: three runs (flash launches 0
                 times) and a profiled replayed run;
 13b. gemma3-27b — with whisper freed, full-width gemma3-27b in bf16 cut
                 to 12 of its 62 layers (d_model 5376, 32/16 heads of 128,
                 d_ff 21504, vocab 262144 tied, window 1024 with every 6th
                 layer global, so 2 global layers; 62 until the script
                 overran its time on a slower host; the weights drawn from
                 a seed on the card): its paged engine (the serve CLI's build over
                 the bf16 config: the CLI has no dtype flag, as the
                 reference's has none):
                 5 requests of 1100-1400 tokens after a shared 64-token
                 prefix, 32 new tokens each, 4 slots, 4 lanes, horizon 8,
                 block 16, max_len 1536, through run_paged_engine (three
                 runs, the checks of phase 5, a profiled replayed run);
                 each request's first token against the argmax of
                 Model.forward at its prompt's last position wherever that
                 forward's top-2 margin exceeds 2e-2 of its largest
                 |logit| (the positions held and skipped printed; fails if
                 none is held); then Model.forward on [1, 4096] with
                 local_banded and without, each timed twice after a
                 warm-up with its peak: the banded logits within 2e-2 of
                 the scanned ones' largest |logit|, argmax agreement
                 printed. Prints the weights' bytes, the engine's and the
                 phase's peak memory and the phase's seconds;
 14. dryrun    — the dry-run (repro_torch.launch.dryrun: one rank's local
                 program on meta tensors, its FLOPs, bytes, live bytes and
                 collectives counted) for every arch at decode_32k on the
                 pod mesh (32, 8), one line a record: args GiB a GPU, the
                 compute, memory and collective terms, the bottleneck. Then
                 one record made real: qwen2-0.5b at decode_32k on the
                 card's host mesh (1, 1), bf16, 128 rows of a 32768-token
                 cache, at the largest depth whose predicted peak is under
                 90% of the card's memory (all 24 layers if it fits). Its
                 parameters and cache are drawn from a seeded generator
                 and Model.decode_step runs at position 32767. Fails
                 unless (a) the memory allocated for the arguments is the
                 record's argument_bytes within 1%, (b) FlopCounterMode
                 counts the record's FLOPs exactly on the card's step (the
                 contiguous decode runs no kernel), (c) the median step is
                 at least 0.9 x the arguments over HBM bandwidth and 0.7 x
                 the record's memory_s (a byte count that counts too much
                 fails), and the measured peak (max_memory_allocated) is
                 within 25% of the record's peak_bytes. Prints the step,
                 memory_s, their ratio and both peaks. The same again
                 with gqa_no_repeat (mha's grouped einsum, no KV repeat),
                 and the two steps, peaks and byte counts side by side;
                 then the graphs_vs_eager summary line.

The last two lines are the kernels record (one entry per TPU kernel and
per backward kernel, the flash backward once in f32 and once in bf16
(``flash_attention_backward_bf16``, launched by the train-bf16 phase),
its launches summed over the paths that run it, by
path in ``launches_by_path``, the other shapes in ``other_shapes``) and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import contextlib
import dataclasses
import datetime
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import msgpack  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core.cluster import Cluster, ServerSpec  # noqa: E402
from repro_torch.core.iterator import (ControlChannel,  # noqa: E402
                                       SynergyIterator)
from repro_torch.core.job import Job  # noqa: E402
from repro_torch.core.profiler import (OptimisticProfiler,  # noqa: E402
                                       ProfilerConfig)
from repro_torch.core.runtime import LiveJobSpec, LiveRuntime  # noqa: E402
from repro_torch.core.sensitivity import (ARCH_SENSITIVITY,  # noqa: E402
                                          MODEL_ZOO, WorkloadModel)
from repro_torch.core.simulator import simulate  # noqa: E402
from repro_torch.core.trace import (TraceConfig, generate,  # noqa: E402
                                    philly_trace)
from repro_torch.data.pipeline import DataConfig, DataPipeline  # noqa: E402
from repro_torch.kernels import build, cost, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_matmul as gmm  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch import trace_report  # noqa: E402
from repro_torch.launch.mesh import F32_FLOPS  # noqa: E402
from repro_torch.launch.mesh import HBM_BW as HBM_BPS  # noqa: E402
from repro_torch.models import encdec, layers, mamba2, moe  # noqa: E402
from repro_torch.models.api import build_model, materialize  # noqa: E402
from repro_torch.models.convert import state_to_jax  # noqa: E402
from repro_torch.obs import (NULL_PROFILER, NULL_TRACER, Tracer,  # noqa: E402
                             load_trace, to_chrome_trace, validate_events,
                             write_chrome_trace)
from repro_torch.serve import graphs  # noqa: E402
from repro_torch.train import checkpoint, optimizer  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.serve import (BlockManager, ElasticController,  # noqa: E402
                               FaultInjector, FaultSchedule, ServeEngine,
                               ServeRequest, Tenant, TenantRegistry,
                               philly_requests, plan_allocation,
                               profile_class, profiles_from_requests,
                               run_replay)

HQ, HKV, D, BS, MAX_LEN, SLOTS = 14, 2, 64, 16, 1024, 8
MB = MAX_LEN // BS
NB = SLOTS * MB
#: tests/test_kernels.py's tolerances
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ENGINE_ARGS = ["--arch", "qwen2-0.5b", "--preset", "full", "--engine",
               "continuous", "--cache", "paged", "--slots", str(SLOTS),
               "--batch", "16", "--block-size", str(BS), "--prefill-lanes",
               "4", "--prompt-len", "256", "--shared-prefix", "64",
               "--max-new", "64", "--max-len", str(MAX_LEN),
               "--decode-horizon", "8", "--seed", "0", "--device", "cuda"]
#: the sampled phase's request set
SAMPLED_ARGS = ENGINE_ARGS + ["--batch", "8", "--max-new", "16"]
#: the depth every qwen2-0.5b engine of the engine, sampled, chaos, obs
#: and sharded phases serves at: 12 of its 24 layers (24 until the script
#: overran its time on a slower host; the width stays whole)
Q_ENGINE_LAYERS = 12
OLMOE_ARGS = ["--arch", "olmoe-1b-7b", "--preset", "full", "--engine",
              "continuous", "--cache", "contiguous", "--slots", "4",
              "--batch", "8", "--prompt-len", "128", "--max-new", "64",
              "--max-len", "256", "--decode-horizon", "8", "--seed", "0",
              "--device", "cuda"]
KERNELS = {
    "paged_decode": dict(
        wrapper=ops.paged_attention, plain=pa.paged_attention_plain,
        replaces="src/repro/kernels/paged_attention.py:202"),
    "paged_prefill": dict(
        wrapper=ops.paged_prefill_attention,
        plain=pa.paged_prefill_attention_plain,
        replaces="src/repro/kernels/paged_attention.py:154"),
}
CSRC = "src/repro_torch/kernels/csrc/"
#: olmoe-1b-7b: q/k/v heads, head_dim, experts, expert capacity of a
#: 256-token prompt (moe.capacity), d_model, expert width
OL_H, OL_D, OL_E, OL_C, OL_DM, OL_F = 16, 128, 64, 40, 2048, 1024
#: phi-3-vision-4.2b: q = kv heads, head_dim; the forward phase's
#: sequence (576 patch positions, then text) and patch count
PHI_H, PHI_D, PHI_S, PHI_P = 32, 96, 1024, 576
#: gemma3-27b served in bf16 (the gemma3 phase): q / kv heads, head_dim,
#: the local layers' window, max_len, slots and prefill lanes; its request
#: set (5 requests of 1100-1400 tokens after a shared 64-token prefix, 32
#: new tokens each, so the prompts pass the window and a freed slot is
#: reused; 6 until the train-bf16 phase came) and the banded-against-scanned
#: forward's length
G3_H, G3_KV, G3_D, G3_W, G3_MAX_LEN, G3_SLOTS, G3_LANES = (32, 16, 128, 1024,
                                                          1536, 4, 4)
G3_N, G3_PREFIX, G3_LENGTHS, G3_NEW, G3_S = 5, 64, (1100, 1400), 32, 4096
#: the depth gemma3-27b serves at: 12 of its 62 layers (layers 6 and 12
#: global, the rest local; 62 until the script overran its time on a
#: slower host), at full width
G3_LAYERS = 12
#: the largest |logit| share within which the banded forward must agree
#: with the scanned one, and beyond which a forward's top-2 margin holds the
#: paged engine's first token (bf16: ~3 significant digits)
G3_TOL = 2e-2
#: the paged engines' kernel shapes: (path, Hq, Hkv, D, MB, NB, decode
#: rows, prefill rows, the positions the engine's requests span, the
#: windows checked, the (dtype, window) of the timed call); the chaos
#: engine's pool grows from 48 to 96 blocks, its largest is held
F32_FULL = (torch.float32, 0)
PAGED_SHAPES = (("olmoe-1b-7b paged", OL_H, OL_H, OL_D, 256 // BS, 64, 4, 4,
                 96, 224, (0, 5), F32_FULL),
                ("phi-3-vision-4.2b paged", PHI_H, PHI_H, PHI_D, 512 // BS,
                 128, 4, 4, 128, 288, (0, 5), F32_FULL),
                ("qwen2-0.5b chaos", HQ, HKV, D, 256 // BS, 96, SLOTS, 4, 32,
                 96, (0, 5), F32_FULL),
                ("qwen2-0.5b sharded rank", HQ // 2, HKV // 2, D, MB, NB,
                 SLOTS, 4, 192, 384, (0, 5), F32_FULL),
                ("qwen2-0.5b data rank", HQ, HKV, D, MB, NB, SLOTS // 2, 2,
                 192, 384, (0, 5), F32_FULL),
                ("gemma3-27b paged", G3_H, G3_KV, G3_D, G3_MAX_LEN // BS,
                 G3_SLOTS * G3_MAX_LEN // BS, G3_SLOTS, G3_LANES, 960,
                 G3_LENGTHS[1] + G3_NEW, (0, G3_W), (torch.bfloat16, G3_W)))
#: the sharded phase (module docstring): its request set, the data runs'
#: arrival rate (two a step: at 0.5 every paged prefill round held one
#: lane, which 'data' 2 does not split), and the rank processes' time
#: limit (s)
SHARD_N, SHARD_NEW, SHARD_DP_RATE = 8, 32, 2.0
SHARD_TIMEOUT = 400
#: the sequence-sharded runs on mesh (1, 4): the ranks the pools' positions
#: split over (qwen2-0.5b's 2 KV heads do not divide 4: a paged rank holds
#: 4 of each block's 16 offsets), the contiguous run's depth and its
#: prompts' lengths, each a multiple of 4 so every prefill runs q-seq
SEQ_M, SEQ_CONTIG_LAYERS = 4, 4
#: the paged (1, 4) run's depth: 6 of qwen2-0.5b's 24 layers (24 until the
#: train-bf16 phase came, then 12: the script keeps to its time)
SEQ_PAGED_LAYERS = 6
SEQ_PROMPTS = (64, 96, 128, 160, 192, 224, 256, 120)
#: the flash query-offset case: a contiguous rank's block of 64 query rows
#: at offset 192 over 256 keys (rank 3 of a 256-token prompt on (1, 4))
OFF_SQ, OFF_Q0, OFF_SK = 64, 192, 256
#: the rank processes' device type
SHARD_DEVICE = "cuda"
#: the recurrent families served tensor-parallel on mesh (1, 2) after the
#: qwen2 runs: zamba2's 81 Mamba2 blocks cut to 6 (one shared-block call),
#: whisper's 32 decoder layers to 2, mamba2's 48 layers to 12 (12, 4 and
#: 48 until the train-bf16 phase came, then 6, 2 and 24), and mamba2 on
#: mesh (2, 1) to 24 (48 until then); each serves
#: REC_SHARD_N requests of 8-16 prompt tokens and 4-12 new ones on 4
#: slots, horizon 8, max_len 64 (freed slots are reused)
REC_SHARD_N, REC_SHARD_SLOTS, REC_SHARD_MAX_LEN = 6, 4, 64
Z_SHARD_LAYERS, W_SHARD_LAYERS, M2_SHARD_LAYERS = 6, 2, 12
M2_DP_SHARD_LAYERS = 24
#: the tensor-parallel mamba2-780m forward on mesh (1, 2): [1, S] tokens,
#: held to the single-process forward within this share of its largest
#: |logit|. 1e-4 holds at smoke depth on the CPU; through 48 random
#: layers the split products' other summation orders reach 1.24e-4 on an
#: H100 (1.18e-3 of 9.52), as the single-process forward's own gap does
#: when only the SSD scan's rounding changes (1.14e-4, ``plain_gap``,
#: printed beside it); the limit is about 2.5x those readings
M2_SHARD_S, M2_SHARD_TOL = 512, 3e-4
#: mamba2-780m: SSM heads, head dim, state, chunk; the forward phase's
#: batch and sequence
M2_H, M2_P, M2_N, M2_Q, M2_B, M2_S = 48, 64, 128, 256, 2, 4096
#: the SSD scan's time at that shape before its tensor-core redesign (one
#: CTA per row and 32 columns of P walking the chunks in order, SIMT f32;
#: NVIDIA H100 80GB HBM3, 700 W, this script's kernels phase)
SIMT_SSD_MS = 4.7081
#: the olmoe paged engine's request set: 8 requests of 64-128 tokens after
#: a shared 32-token prefix (two full blocks)
OLMOE_PAGED_ARGS = ["--arch", "olmoe-1b-7b", "--preset", "full", "--engine",
                    "continuous", "--cache", "paged", "--slots", "4",
                    "--batch", "8", "--block-size", str(BS),
                    "--prefill-lanes", "4", "--prompt-len", "128",
                    "--shared-prefix", "32", "--max-new", "64", "--max-len",
                    "256", "--decode-horizon", "8", "--seed", "0",
                    "--device", "cuda"]
PHI3_ARGS = ["--arch", "phi-3-vision-4.2b", "--preset", "full", "--engine",
             "continuous", "--cache", "paged", "--slots", "4", "--batch",
             "8", "--block-size", str(BS), "--prefill-lanes", "4",
             "--prompt-len", "256", "--max-new", "32", "--max-len", "512",
             "--decode-horizon", "8", "--seed", "0", "--device", "cuda"]
MAMBA2_ARGS = ["--arch", "mamba2-780m", "--preset", "full", "--engine",
               "continuous", "--cache", "contiguous", "--slots", "4",
               "--batch", "4", "--prompt-len", "128", "--max-new", "32",
               "--max-len", "256", "--decode-horizon", "8", "--seed", "0",
               "--device", "cuda"]
#: zamba2-7b: SSM heads, head dim, state, chunk, the forward phase's
#: sequence (batch 1) and its decode chain's length
Z_H, Z_P, Z_N, Z_Q, Z_S, Z_CHAIN = 112, 64, 64, 256, 4096, 128
#: whisper-large-v3: heads (q = kv), head_dim, the forward phase's decoder
#: length, its decode chain's length
W_H, W_D, W_S, W_CHAIN = 20, 64, 448, 64
#: the zamba2-7b and whisper-large-v3 contiguous engines' request set: 8
#: requests of 32-64 tokens, 32 new tokens each, 4 slots, horizon 8
ZAMBA2_ARGS = ["--arch", "zamba2-7b", "--preset", "full", "--engine",
               "continuous", "--cache", "contiguous", "--slots", "4",
               "--batch", "8", "--prompt-len", "64", "--max-new", "32",
               "--max-len", "256", "--decode-horizon", "8", "--seed", "0",
               "--device", "cuda"]
WHISPER_ARGS = ZAMBA2_ARGS[:1] + ["whisper-large-v3"] + ZAMBA2_ARGS[2:] + [
    "--max-len", str(W_S)]
#: the depths the olmoe, zamba2, whisper and mamba2 engines serve at, cut
#: so the script keeps to its time: olmoe's 16 layers to 4, zamba2's 81
#: Mamba2 blocks to 15 (two shared-block calls, then the 3 trailing
#: blocks), whisper's 32 decoder layers to 8 (its encoder does not serve),
#: mamba2's 48 layers to 12 (8, 27, 16 and 24 until the script overran its
#: time on a slower host); every width, and the forward phases' depths,
#: stay whole
OL_ENGINE_LAYERS, Z_ENGINE_LAYERS, W_ENGINE_LAYERS = 4, 15, 8
M2_ENGINE_LAYERS = 12
#: the decode chains' tolerance against the forward's logits (the mamba2
#: chain's, tests/test_smoke_archs.py:82-95)
CHAIN_TOL = 2e-3
#: the chaos phase: the engine phase's qwen2-0.5b weights on a paged
#: engine of 8 slots, block 16, max_len 256, horizon 8, 4 lanes and
#: CHAOS_BLOCKS blocks (16 slots' worth of requests need up to 6 each);
#: 24 Philly requests at 2 a step (prompts 32-64, budgets 1-32), jobs of
#: more than one GPU on the "batch" tenant
CHAOS_BLOCKS = 48
CHAOS_REQS = dict(n=24, load=2.0, prompt_len=64, max_new=32, seed=7,
                  max_len=256)
#: all eight kinds: a shrink and a device failure that come back, a join
#: past the constructed pool (``grow_physical`` migrates the live blocks)
CHAOS_FAULTS = ("defer_storm@2:duration=3,tenant_slowdown@4:tenant=batch:"
                "duration=6,slot_kill@6,arrival_burst@8:n=4:prompt_len=64:"
                "max_new=16:tenant=interactive,prefix_flush@10,"
                "pool_shrink@12:blocks=20:restore_after=8,"
                "device_fail@16:blocks=8:restore_after=10,"
                "device_join@22:blocks=40")


#: the synergy phase's live job (the reference runtime's ``_profile``):
#: phi-3-vision-4.2b on one GPU, batches of SYN_B sequences of PHI_S
#: tokens, SYN_PROBE_ITERS timed steps a probe (the runtime's default), its
#: Trainer SYN_LAYERS of the 32 layers deep at full width (32 until the
#: gemma3 phase came, then 16: the script's time)
SYN_B, SYN_PROBE_ITERS, SYN_LAYERS = 2, 2, 8
#: its simulator runs: 16 of the paper's servers (128 GPUs) on a Philly
#: trace under SRTF for each allocator, then Synergy-OPT on 4 servers and
#: tests/test_scheduler.py:163's trace cut to 40 jobs
SIM_SERVERS = 16
SIM_TRACE = dict(n_jobs=300, split=(20, 70, 10), seed=7, jobs_per_hour=12.0)
SIM_ALLOCATORS = ("proportional", "greedy", "tune", "tune_split")
OPT_SERVERS = 4
OPT_TRACE = dict(n_jobs=40, split=(20, 70, 10), arrival="poisson",
                 jobs_per_hour=6.0, seed=9)


def phase(name: str) -> None:
    print(f"== {name} ({time.strftime('%H:%M:%S')})", flush=True)


# ---------------------------------------------------------------------------
# build reports
# ---------------------------------------------------------------------------
#: the kernels redesigned for the tensor cores: their SASS must hold HMMA
MMA_KERNELS = ("flash_attention_kernel", "paged_decode_kernel",
               "paged_prefill_kernel",
               "grouped_matmul_kernel", "ssd_scan_state_kernel",
               "ssd_scan_chunk_kernel", "flash_bwd_dq_kernel",
               "flash_bwd_dkdv_kernel", "ssd_scan_bwd_chunk_kernel")


def print_ptxas(report: str) -> None:
    """One line per kernel of ``nvcc -Xptxas -v``: registers, static shared
    memory, stack and spills (the attention kernels' dynamic shared memory
    is in their sources: attention_mma.cuh smem_bytes)."""
    entry = spill = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], ""
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "Used" in line:
            print(f"ptxas {entry}: {line.split(':', 1)[1].strip()}; "
                  f"{spill}", flush=True)
            entry = None


def check_tensor_cores(lib) -> None:
    """cuobjdump -sass of the built library: count the tensor-core (HMMA)
    instructions of each redesigned kernel; fail if one has none."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    for name in MMA_KERNELS:
        found = {f: n for f, n in counts.items() if name in f}
        print(f"HMMA instructions in {name}: {found}", flush=True)
        if not found or min(found.values()) == 0:
            raise SystemExit(f"FAIL: {name} runs no tensor-core instruction")


# ---------------------------------------------------------------------------
# kernel inputs, bound, timing
# ---------------------------------------------------------------------------
def make_case(b: int, c: int, dtype, seed: int, pad_row: bool,
              lo: int = 192, hi: int = 384, shape=None):
    """Inputs at a paged engine's shapes (``shape`` = (Hq, Hkv, D, MB, NB);
    default qwen2-0.5b's): a [NB, BS, Hkv, D] pool, rows at positions
    lo..hi-1 (default 192..383: prompt + decode of the engine phase)
    holding distinct scattered blocks, optionally a last all -1 (padding)
    row."""
    hq, hkv, d, mb, nb = shape or (HQ, HKV, D, MB, NB)
    g = torch.Generator(device="cuda").manual_seed(seed)
    kp = torch.randn(nb, BS, hkv, d, generator=g, device="cuda").to(dtype)
    vp = torch.randn(nb, BS, hkv, d, generator=g, device="cuda").to(dtype)
    start = torch.randint(lo, hi - c, (b,), generator=g, device="cuda",
                          dtype=torch.int32)
    perm = torch.randperm(nb, generator=g, device="cuda").to(torch.int32)
    tables = torch.full((b, mb), -1, dtype=torch.int32, device="cuda")
    stride = min(mb, nb // b)               # a pool of fewer than b * MB
    for i in range(b - 1 if pad_row else b):
        n = (int(start[i]) + c - 1) // BS + 1
        tables[i, :n] = perm[i * stride:i * stride + n]
    q = torch.randn(b, c, hq, d, generator=g, device="cuda").to(dtype)
    return (q[:, 0] if c == 1 else q), kp, vp, tables, start


def bound_terms(q, kp, tables, start, c: int, window: int, mma: bool):
    """Least time for this call's work: every needed byte read once (q,
    the K/V blocks some query sees, tables, positions) and the output
    written once, over HBM bandwidth; the QK and PV flops of the visible
    (query, key) pairs at ``cost.bound_ms``'s rate. Returns (bytes ms,
    ops ms)."""
    _, bs, hkv, d = kp.shape
    flops, nbytes = cost.paged_attention(
        q.shape[-2], hkv, d, bs, q.element_size(), c, window,
        tables.cpu().tolist(), start.cpu().tolist())
    return cost.bound_ms(flops, nbytes, f32=q.dtype is torch.float32,
                         mma=mma)


#: torch.cuda._sleep's cycles a second at the H100 SXM's 1980 MHz clock
SPIN_PER_S = 1.98e9


def time_ms(fn, flush: torch.Tensor, reps: int = 50,
            hold: bool = True) -> float:
    """Median CUDA-event time of ``fn`` with the L2 flushed before each
    launch. A device spin before the start event keeps the stream busy
    while the host enqueues ``fn``, so the events time the device work
    alone: ~0.1 ms, or twice the longer enqueue of the last two warm-up
    calls where that is longer (SDPA's forward + ``autograd.grad`` takes
    ~0.3 ms). With ``hold`` False (PR 11-13's method) the Python wrapper's
    enqueue cost falls inside the events whenever it exceeds the flush."""
    fn()
    enqueue = 0.0
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue = max(enqueue, time.perf_counter() - t0)
    torch.cuda.synchronize()
    spin = max(200_000, int(2 * enqueue * SPIN_PER_S))
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        flush.zero_()
        if hold:
            torch.cuda._sleep(spin)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in ev)[reps // 2]


def host_ms(fn, reps: int = 50) -> float:
    """Host wall time per call of enqueuing ``fn`` (the wrapper's checks,
    allocations and launches), with the stream held by a ~10 ms device
    spin so that no call waits on the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


def wrapper_times(fn, flush: torch.Tensor) -> dict:
    """The times of one kernel wrapper besides ``time_ms``'s: the events
    without the hold (PR 11-13's method) and the host's enqueue cost."""
    return dict(unheld_ms=time_ms(fn, flush, hold=False),
                host_ms=host_ms(fn))


def sdpa_call(q, kp, vp, tables, start, c: int, window: int,
              pos_base=None):
    """torch's scaled_dot_product_attention over the gathered K/V with the
    same mask: the library yardstick (gather and mask built outside).
    ``pos_base``: a pool slice's keys at their global positions (the
    partial mode's)."""
    kg, vg, k_pos, assigned = pa.paged_kv_gather(kp, vp, tables)
    if pos_base is not None:
        k_pos = pa.key_positions(tables.shape[1], kp.shape[1], pos_base,
                                 "cuda")
    qq = (q[:, None] if c == 1 else q).transpose(1, 2)           # [B,Hq,C,D]
    g = q.shape[-2] // kp.shape[2]
    kk = kg.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    vv = vg.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    q_pos = (start.long()[:, None]
             + torch.arange(c, device="cuda")[None, :])[:, :, None]
    mask = assigned[:, None, :] & (k_pos <= q_pos)
    if window:
        mask &= k_pos > q_pos - window
    mask = mask[:, None]                                         # [B,1,C,K]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask)


def check_kernels(flush: torch.Tensor) -> dict:
    """Every kernel against its plain version; time the main-path case
    (float32, window 0: decode W=8, prefill [4, 16])."""
    rec = {}
    for name, kern in KERNELS.items():
        shapes = [(1, 1), (8, 1)] if name == "paged_decode" else [(4, 16)]
        for (b, c) in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                for window in (0, 5):
                    args = make_case(b, c, dtype, seed=b * 131 + c + window,
                                     pad_row=b > 1)
                    what = (f"{name} B={b} C={c} {str(dtype)[6:]} "
                            f"window={window}")
                    out = kern["wrapper"](*args, window)
                    err = _compare(what, out, kern["plain"](*args, window),
                                   dtype)
                    if b > 1 and not bool((out[-1] == 0).all()):
                        raise SystemExit(f"FAIL: {what}: the all -1 table "
                                         "row is not zero")
                    if dtype is torch.float32 and window == 0 and b > 1:
                        q, kp, vp, tables, start = args
                        ms = time_ms(lambda: kern["wrapper"](*args, 0), flush)
                        plain_ms = time_ms(lambda: kern["plain"](*args, 0),
                                           flush)
                        lib_ms = time_ms(sdpa_call(q, kp, vp, tables, start,
                                                   c, 0), flush)
                        rec[name] = _record(
                            name, "paged_attention.cu", kern["replaces"],
                            err, ms, plain_ms,
                            *bound_terms(q, kp, tables, start, c, 0, True),
                            lib_ms,
                            dict(B=b, C=c, Hq=HQ, Hkv=HKV, D=D, BS=BS, MB=MB,
                                 dtype="float32"),
                            bound_terms(q, kp, tables, start, c, 0,
                                        False)[1],
                            wrapper_times(lambda: kern["wrapper"](*args, 0),
                                          flush))
    return rec


def check_splits(flush: torch.Tensor, name: str) -> None:
    """The paged kernel ``name`` (decode: W 8 slots; prefill: [4, 16]
    chunks) at the engine's positions (192-383) and at a long context
    (960-1023: the table full at MB 64), at each split width (the module
    constant ``DECODE_SPLIT_KEYS`` or ``SPLIT_KEYS``, set here and restored)
    against the plain version in f32 and, with a last all -1 row that must
    come out zero, in f32 and bf16; the f32 call timed beside SDPA on the
    gathered K/V and the bound: the measurement behind the constant."""
    decode = name == "paged_decode"
    attr = "DECODE_SPLIT_KEYS" if decode else "SPLIT_KEYS"
    b, c = (SLOTS, 1) if decode else (4, 16)
    cuda = pa.paged_attention_cuda if decode else pa.paged_prefill_cuda
    plain = KERNELS[name]["plain"]
    keys = getattr(pa, attr)
    try:
        for what, lo, hi in (("engine", 192, 384), ("long context", 960,
                                                     MAX_LEN)):
            args = make_case(b, c, torch.float32, seed=lo, pad_row=False,
                             lo=lo, hi=hi)
            padded = [make_case(b, c, dtype, seed=lo + 1, pad_row=True,
                                lo=lo, hi=hi)
                      for dtype in (torch.float32, torch.bfloat16)]
            q, kp, vp, tables, start = args
            exp = plain(*args)
            lib_ms = time_ms(sdpa_call(q, kp, vp, tables, start, c, 0), flush)
            bound = max(bound_terms(q, kp, tables, start, c, 0, True))
            for cols in (1, 2, 4, 8, 16, MB):
                setattr(pa, attr, cols * BS)
                n = pa.split_plan(MB, BS, cols * BS)[1]
                run = lambda: cuda(*args, 0)  # noqa: E731
                what_cols = f"{name} {what} {cols} columns a split"
                _compare(what_cols, run(), exp, torch.float32)
                for pad in padded:
                    dtype = pad[0].dtype
                    out = cuda(*pad, 0)
                    what_pad = f"{what_cols} {str(dtype)[6:]}, all -1 last row"
                    _compare(what_pad, out, plain(*pad), dtype)
                    if not bool((out[-1] == 0).all()):
                        raise SystemExit(f"FAIL: {what_pad} is not zero")
                ms = time_ms(run, flush)
                print(f"{what_cols}, starts {sorted(start.tolist())} ({n} "
                      f"splits, {b * HKV * n} CTAs): kernel {ms:.4f} ms, "
                      f"SDPA {lib_ms:.4f} ms, kernel / library "
                      f"{ms / lib_ms:.3f}, bound {bound:.5f} ms", flush=True)
    finally:
        setattr(pa, attr, keys)


#: the kernels line's keys of a timed case that ``other_shapes`` keeps
SHAPE_KEYS = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "max_abs_err")


def check_engine_shapes(flush: torch.Tensor, rec: dict) -> None:
    """The paged kernels at the shapes of the olmoe-1b-7b and
    phi-3-vision-4.2b paged engines (one q head a kv head: G 1; head_dim
    128 and 96), of the chaos phase's qwen2-0.5b engine (14 / 2 heads
    of 64, MB 16, its grown 96-block pool), of one sharded rank and of the
    gemma3-27b engine (32 / 16 heads of 128, MB 96, positions across its
    1024 window): f32 and bf16, each shape's windows (0 and 5; gemma3's 0
    and 1024), a last all -1 row that must come out zero, against the
    plain versions; the shape's timed call (f32 at window 0; gemma3's bf16
    at 1024) timed beside its plain version, SDPA on the gathered K/V and
    its bound, kept in the kernel's ``other_shapes``."""
    for (path, hq, hkv, d, mb, nb, dec_b, pre_b, lo, hi, windows,
         (t_dtype, t_window)) in PAGED_SHAPES:
        shape = (hq, hkv, d, mb, nb)
        for name, kern in KERNELS.items():
            b, c = (dec_b, 1) if name == "paged_decode" else (pre_b, BS)
            for dtype in (torch.float32, torch.bfloat16):
                for window in windows:
                    args = make_case(b, c, dtype, seed=hq + d + window,
                                     pad_row=True, lo=lo, hi=hi, shape=shape)
                    what = (f"{name} {path} shape B={b} C={c} Hq={hq} "
                            f"Hkv={hkv} D={d} {str(dtype)[6:]} "
                            f"window={window}")
                    out = kern["wrapper"](*args, window)
                    _compare(what, out, kern["plain"](*args, window), dtype)
                    if not bool((out[-1] == 0).all()):
                        raise SystemExit(f"FAIL: {what}: the all -1 table "
                                         "row is not zero")
            args = make_case(b, c, t_dtype, seed=hq + d, pad_row=False,
                             lo=lo, hi=hi, shape=shape)
            q, kp, vp, tables, start = args
            t_name = str(t_dtype)[6:]
            err = _compare(f"{name} {path} shape, {t_name}, window "
                           f"{t_window}, all rows",
                           kern["wrapper"](*args, t_window),
                           kern["plain"](*args, t_window), t_dtype)
            r = _record(
                name, "paged_attention.cu", kern["replaces"], err,
                time_ms(lambda: kern["wrapper"](*args, t_window), flush),
                time_ms(lambda: kern["plain"](*args, t_window), flush),
                *bound_terms(q, kp, tables, start, c, t_window, True),
                time_ms(sdpa_call(q, kp, vp, tables, start, c, t_window),
                        flush),
                dict(path=path, B=b, C=c, Hq=hq, Hkv=hkv, D=d, BS=BS, MB=mb,
                     NB=nb, positions=[lo, hi], dtype=t_name,
                     window=t_window))
            rec[name].setdefault("other_shapes", []).append(
                {k: r[k] for k in SHAPE_KEYS})


def _compare_lse(what: str, out, exp, dtype) -> float:
    """A partial call's row log-sum-exp against its plain version's: -inf
    (no visible key) in the same rows, the others within the dtype's
    tolerance."""
    torch.cuda.synchronize()
    seen = torch.isfinite(exp)
    if not torch.equal(torch.isfinite(out), seen):
        raise SystemExit(f"FAIL: {what}: log-sum-exp rows with no key "
                         "differ from the plain version's")
    return _compare(f"{what} log-sum-exp", out[seen], exp[seen], dtype)


def check_partial(flush: torch.Tensor) -> dict:
    """The paged decode (W 8) and prefill ([4, 16]) in partial mode at the
    kv-seq rank shape (qwen2-0.5b's 14 / 2 heads of 64, G 7; a pool whose
    16-position blocks are split over SEQ_M ranks: local block 4 at
    offsets 0, 4, 8 and 12; MB 64, positions 192-384; f32 and bf16,
    windows 0 and 5, an all -1 row), each rank's slice as a strided view
    of the whole pool and as a contiguous local pool, output and row
    log-sum-exp against the plain version; the SEQ_M partials merged
    (``sharding.combine_partials``, merge_partials' arithmetic) against
    one whole-pool call of the plain-mode kernel. The f32 window-0 call on
    rank 1's local pool timed beside its plain version, SDPA on its
    gathered K/V with the mask at their global positions, and its bound."""
    from repro_torch.dist import sharding as shd
    rec = {}
    n = BS // SEQ_M
    for name in ("paged_decode_partial", "paged_prefill_partial"):
        decode = name == "paged_decode_partial"
        b, c = (SLOTS, 1) if decode else (4, BS)
        wrapper = (ops.paged_attention_partial if decode
                   else ops.paged_prefill_partial)
        whole = (ops.paged_attention if decode
                 else ops.paged_prefill_attention)
        plain = KERNELS["paged_decode" if decode else "paged_prefill"][
            "plain"]
        for dtype in (torch.float32, torch.bfloat16):
            for window in (0, 5):
                args = make_case(b, c, dtype, seed=7 * b + c + window,
                                 pad_row=True)
                q, kp, vp, tables, start = args
                parts = []
                for r in range(SEQ_M):
                    base = (BS, r * n)
                    views = (kp[:, r * n:(r + 1) * n],
                             vp[:, r * n:(r + 1) * n])
                    for kind, (ks, vs) in (
                            ("view", views),
                            ("local", [t.contiguous() for t in views])):
                        what = (f"{name} B={b} C={c} {str(dtype)[6:]} "
                                f"window={window} offset {r * n} ({kind})")
                        o, lse = wrapper(q, ks, vs, tables, start, window,
                                         base)
                        eo, el = plain(q, ks, vs, tables, start, window,
                                       base, return_lse=True)
                        _compare(what, o, eo, dtype)
                        _compare_lse(what, lse, el, dtype)
                        if not (bool((o[-1] == 0).all())
                                and bool(torch.isinf(lse[-1]).all())):
                            raise SystemExit(f"FAIL: {what}: the all -1 "
                                             "row is not 0 with lse -inf")
                    parts.append((o, lse))
                merged = shd.combine_partials(
                    torch.stack([o for o, _ in parts]),
                    torch.stack([l for _, l in parts])).to(dtype)
                _compare(f"{name} B={b} C={c} {str(dtype)[6:]} window="
                         f"{window}: {SEQ_M} partials merged against one "
                         "whole-pool call", merged,
                         whole(q, kp, vp, tables, start, window), dtype)
        q, kp, vp, tables, start = make_case(b, c, torch.float32, seed=11,
                                             pad_row=False)
        base = (BS, n)
        ks, vs = (t[:, n:2 * n].contiguous() for t in (kp, vp))
        run = lambda: wrapper(q, ks, vs, tables, start, 0, base)  # noqa
        eo, el = plain(q, ks, vs, tables, start, 0, base, return_lse=True)
        o, lse = run()
        err = max(_compare(f"{name} timed case", o, eo, torch.float32),
                  _compare_lse(f"{name} timed case", lse, el, torch.float32))
        flops, nbytes = cost.paged_attention(
            HQ, HKV, D, n, 4, c, 0, tables.cpu().tolist(),
            start.cpu().tolist(), pos_base=base, lse=True)
        rec[name] = _record(
            name, "paged_attention.cu",
            KERNELS["paged_decode" if decode else "paged_prefill"][
                "replaces"], err, time_ms(run, flush),
            time_ms(lambda: plain(q, ks, vs, tables, start, 0, base,
                                  return_lse=True), flush),
            *cost.bound_ms(flops, nbytes),
            time_ms(sdpa_call(q, ks, vs, tables, start, c, 0, base), flush),
            dict(B=b, C=c, Hq=HQ, Hkv=HKV, D=D, BS=n, BS_global=BS,
                 offset=n, MB=MB, NB=NB, positions=[192, 384],
                 dtype="float32"))
    return rec


def check_flash_offset(flush: torch.Tensor) -> dict:
    """Flash with a query offset at the contiguous (1, 4) rank's shape: q
    [1, 64, 14, 64] at offset 192 over 256 keys of 2 KV heads, f32 and
    bf16, windows 0 and 5, against its plain version; the q-seq scheme's
    four row blocks (offsets 0, 64, 128, 192, each over the keys up to its
    last row) gathered against one self-attention call of the kernel over
    all 256 rows. The f32 call timed beside its plain version, SDPA with
    the explicit mask, and its bound."""
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(OFF_SK)
        q, k, v = (torch.randn(1, OFF_SK, h, D, generator=g,
                               device="cuda").to(dtype)
                   for h in (HQ, HKV, HKV))
        for window in (0, 5):
            rows = q[:, OFF_Q0:OFF_Q0 + OFF_SQ]
            _compare(f"flash_attention_offset q [1, {OFF_SQ}, {HQ}, {D}] "
                     f"at {OFF_Q0} over {OFF_SK} keys {str(dtype)[6:]} "
                     f"window={window}",
                     ops.flash_attention_offset(rows, k, v, OFF_Q0,
                                                window=window),
                     fa.flash_attention_plain(rows, k, v, True, window,
                                              OFF_Q0), dtype)
            blocks = torch.cat([ops.flash_attention_offset(
                q[:, r * OFF_SQ:(r + 1) * OFF_SQ], k[:, :(r + 1) * OFF_SQ],
                v[:, :(r + 1) * OFF_SQ], r * OFF_SQ, window=window)
                for r in range(OFF_SK // OFF_SQ)], dim=1)
            _compare(f"flash_attention_offset {OFF_SK // OFF_SQ} row blocks "
                     f"{str(dtype)[6:]} window={window} against one "
                     "self-attention call", blocks,
                     ops.flash_attention(q, k, v, window=window), dtype)
    g = torch.Generator(device="cuda").manual_seed(OFF_Q0)
    q, k, v = (torch.randn(1, s, h, D, generator=g, device="cuda")
               for s, h in ((OFF_SQ, HQ), (OFF_SK, HKV), (OFF_SK, HKV)))
    run = lambda: ops.flash_attention_offset(q, k, v, OFF_Q0)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(q, k, v, True, 0,  # noqa: E731
                                             OFF_Q0)
    err = _compare("flash_attention_offset timed case", run(), plain(),
                   torch.float32)
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(HQ // HKV, dim=1)
              .contiguous() for t in (k, v))
    mask = (torch.arange(OFF_SK, device="cuda")[None, :]
            <= OFF_Q0 + torch.arange(OFF_SQ, device="cuda")[:, None])
    flops, nbytes = cost.flash_attention(1, OFF_SQ, HQ, HKV, D, 4, True, 0,
                                         q_offset=OFF_Q0, sk=OFF_SK)
    return _record(
        "flash_attention_offset", "flash_attention.cu",
        "src/repro/kernels/flash_attention.py:86", err, time_ms(run, flush),
        time_ms(plain, flush), *cost.bound_ms(flops, nbytes),
        time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), flush),
        dict(B=1, Sq=OFF_SQ, Sk=OFF_SK, q_offset=OFF_Q0, Hq=HQ, Hkv=HKV, D=D,
             causal=True, window=0, dtype="float32"))


def _record(name, source, replaces, err, ms, plain_ms, bytes_ms, ops_ms,
            lib_ms, shape, f32_simt_ms=None, times=None) -> dict:
    """The kernels-line entry of one timed case. ``launches`` is added by
    main from the engine run of the kernel's path. For a tensor-core kernel
    ``f32_simt_ms`` is its operations at the f32 peak outside the tensor
    cores, printed and kept for reference; ``times`` holds
    ``wrapper_times``'s readings."""
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    lib = ("none" if lib_ms is None else
           f"{lib_ms:.4f} ms (kernel / library {ms / lib_ms:.3f})")
    ref = ("" if f32_simt_ms is None else
           f", at the f32 peak outside the tensor cores {f32_simt_ms:.5f}")
    more = "".join(f", {k} {v:.4f}" for k, v in (times or {}).items())
    print(f"{name} {shape}: kernel {ms:.4f} ms{more}, plain {plain_ms:.4f} "
          f"ms, library {lib}, bound {max(bytes_ms, ops_ms):.5f} ms "
          f"({by}; bytes {bytes_ms:.5f}, operations {ops_ms:.5f}{ref})",
          flush=True)
    rec = dict(name=name, route="cuda", source=CSRC + source,
               replaces=replaces, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by=by, library_ms=lib_ms, bound_bytes_ms=bytes_ms,
               bound_ops_ms=ops_ms, shape=shape, **(times or {}))
    if f32_simt_ms is not None:
        rec["bound_ops_f32_simt_ms"] = f32_simt_ms
    return rec


def _compare(what: str, out, exp, dtype, tol=None) -> float:
    """Max abs error of a kernel against its plain version; exits unless
    they agree within the tolerance (the dtype's unless given)."""
    torch.cuda.synchronize()
    diff = (out.float() - exp.float()).abs()
    err = diff.max().item()
    tol = tol or TOL[dtype]
    # allclose's test |out - exp| <= tol + tol |exp|: its worst ratio
    worst = (diff / (tol + tol * exp.float().abs())).max().item()
    ok = (out.shape == exp.shape and out.dtype == exp.dtype
          and torch.allclose(out.float(), exp.float(), atol=tol, rtol=tol))
    print(f"{what}: max_abs_err={err:.3e}, max |exp|="
          f"{exp.float().abs().max().item():.3e} (atol = rtol = {tol}; "
          f"worst ratio to the bound {worst:.3f})", flush=True)
    if not ok:
        raise SystemExit(f"FAIL: {what} disagrees with its plain version")
    return err


def flash_bound(s: int, hq: int, hkv: int, d: int, dtype, causal: bool,
                window: int, mma: bool = True, b: int = 1):
    """Least time for one flash call of batch ``b``: q, k, v read once and
    the output written once over HBM bandwidth; the QK and PV flops of the
    visible (query, key) pairs at ``cost.bound_ms``'s rate. (bytes ms,
    ops ms)."""
    elem = torch.empty((), dtype=dtype).element_size()
    flops, nbytes = cost.flash_attention(b, s, hq, hkv, d, elem, causal,
                                         window)
    return cost.bound_ms(flops, nbytes, f32=dtype is torch.float32, mma=mma)


def check_flash(flush: torch.Tensor) -> dict:
    """The flash kernel against its plain version at olmoe-1b-7b's prefill
    shape, at phi-3-vision-4.2b's forward shape ([1, 1024, 32, 96]) and
    its synergy probe's ([2, 1024, 32, 96]), at whisper-large-v3's decoder
    shape ([1, 448, 20, 64], causal: a partial last row tile) and at edge
    shapes; time the S = 256 f32 call (and, in ``other_shapes``,
    phi-3-vision's, its probe's and whisper's)."""
    cases = [(1, 128, OL_H, OL_H, OL_D, True, 0),
             (1, 256, OL_H, OL_H, OL_D, True, 0),
             (1, 128, 14, 2, 64, True, 5), (1, 128, 14, 2, 64, False, 0),
             (1, 200, OL_H, OL_H, OL_D, True, 0),
             (1, PHI_S, PHI_H, PHI_H, PHI_D, True, 0),
             (SYN_B, PHI_S, PHI_H, PHI_H, PHI_D, True, 0),
             (1, 200, PHI_H, PHI_H, PHI_D, True, 5),
             (1, W_S, W_H, W_H, W_D, True, 0)]
    rec, others = None, []
    for (b, s, hq, hkv, d, causal, window) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(s + hq + d)
            q, k, v = (torch.randn(b, s, h, d, generator=g,
                                   device="cuda").to(dtype)
                       for h in (hq, hkv, hkv))
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            exp = fa.flash_attention_plain(q, k, v, causal, window)
            err = _compare(f"flash B={b} S={s} Hq/Hkv={hq}/{hkv} D={d} "
                           f"causal={causal} window={window} "
                           f"{str(dtype)[6:]}",
                           out, exp, dtype)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if (s, hq, dtype) == (128, OL_H, torch.float32):
                ms = time_ms(lambda: ops.flash_attention(q, k, v), flush)
                lib_ms = time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), flush)
                print(f"flash_attention S=128 f32: kernel {ms:.4f} ms, SDPA "
                      f"{lib_ms:.4f} ms, kernel / library "
                      f"{ms / lib_ms:.3f}", flush=True)
            if (s, hq, dtype) == (256, OL_H, torch.float32):
                ms = time_ms(lambda: ops.flash_attention(q, k, v), flush)
                plain_ms = time_ms(
                    lambda: fa.flash_attention_plain(q, k, v), flush)
                lib_ms = time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), flush)
                rec = _record(
                    "flash_attention", "flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:86", err, ms,
                    plain_ms, *flash_bound(s, hq, hkv, d, dtype, True, 0),
                    lib_ms,
                    dict(B=1, S=s, Hq=hq, Hkv=hkv, D=d, causal=True,
                         window=0, dtype="float32"),
                    flash_bound(s, hq, hkv, d, dtype, True, 0, False)[1],
                    wrapper_times(lambda: ops.flash_attention(q, k, v),
                                  flush))
            path = {(1, PHI_S, PHI_D): "phi-3-vision-4.2b forward",
                    (SYN_B, PHI_S, PHI_D): "phi-3-vision-4.2b synergy train",
                    (1, W_S, W_D): "whisper-large-v3 forward"}.get((b, s, d))
            if path and dtype is torch.float32 and not window:
                others.append(_record(
                    "flash_attention", "flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:86", err,
                    time_ms(lambda: ops.flash_attention(q, k, v), flush),
                    time_ms(lambda: fa.flash_attention_plain(q, k, v), flush,
                            reps=10),
                    *flash_bound(s, hq, hkv, d, dtype, True, 0, b=b),
                    time_ms(lambda: torch.nn.functional
                            .scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True),
                            flush),
                    dict(path=path, B=b, S=s, Hq=hq, Hkv=hkv, D=d,
                         causal=True, window=0, dtype="float32")))
    rec["other_shapes"] = [{k: r[k] for k in SHAPE_KEYS} for r in others]
    return rec


def gmm_bound(x, w, valid, mma: bool = True):
    """Least time for one grouped matmul: the x rows and the weights of the
    experts that have a valid row read once, valid_rows read and the
    whole output written once, over HBM bandwidth; 2 K N flops per valid
    row at ``cost.bound_ms``'s rate. (bytes ms, ops ms)."""
    g, c, k = x.shape
    flops, nbytes = cost.grouped_matmul(
        g, c, k, w.shape[2], x.element_size(),
        None if valid is None else valid.cpu().tolist())
    return cost.bound_ms(flops, nbytes, f32=x.dtype is torch.float32,
                         mma=mma)


def check_grouped_matmul(flush: torch.Tensor) -> dict:
    """The grouped matmul against its plain version at olmoe-1b-7b's
    expert shapes; time every case with all rows valid (the einsum of
    moe_ffn at a 256-token prompt's capacity) beside torch.bmm, f32 and
    bf16, gate-up and down, and the f32 random-rows cases; the gate-up f32
    call is the kernels-line entry."""
    rec = None
    for (k, n) in ((OL_DM, 2 * OL_F), (OL_F, OL_DM)):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(k + n)
            x = torch.randn(OL_E, OL_C, k, generator=g, device="cuda")
            w = torch.randn(OL_E, k, n, generator=g, device="cuda") / k ** 0.5
            x, w = x.to(dtype), w.to(dtype)
            rand = torch.randint(0, OL_C + 1, (OL_E,), generator=g,
                                 device="cuda", dtype=torch.int32)
            part = rand.clone()
            part[::3] = 0
            for kind, valid in (("none", None), ("random", rand),
                                ("partly zero", part)):
                out = ops.grouped_matmul(x, w, valid)
                exp = gmm.grouped_matmul_plain(x, w, valid)
                err = _compare(f"grouped_matmul [{OL_E},{OL_C},{k}]x[{OL_E},"
                               f"{k},{n}] valid_rows={kind} "
                               f"{str(dtype)[6:]}", out, exp, dtype)
                if kind == "partly zero" or (
                        kind == "random" and dtype is not torch.float32):
                    continue
                ms = time_ms(lambda: ops.grouped_matmul(x, w, valid), flush)
                bms = max(gmm_bound(x, w, valid))
                what = f"grouped_matmul K={k} N={n} {str(dtype)[6:]}"
                if kind == "random":
                    print(f"{what} valid_rows=random: kernel {ms:.4f} ms, "
                          f"bound {bms:.5f} ms", flush=True)
                    continue
                lib_ms = time_ms(lambda: torch.bmm(x, w), flush)
                print(f"{what}: kernel {ms:.4f} ms, torch.bmm {lib_ms:.4f} "
                      f"ms, kernel / bmm {ms / lib_ms:.3f}, bound "
                      f"{bms:.5f} ms", flush=True)
                if (k, dtype) != (OL_DM, torch.float32):
                    continue
                plain_ms = time_ms(lambda: gmm.grouped_matmul_plain(x, w),
                                   flush)
                rec = _record(
                    "grouped_matmul", "grouped_matmul.cu",
                    "src/repro/kernels/grouped_matmul.py:48", err, ms,
                    plain_ms, *gmm_bound(x, w, None), lib_ms,
                    dict(G=OL_E, C=OL_C, K=k, N=n, valid_rows=None,
                         dtype="float32"),
                    gmm_bound(x, w, None, mma=False)[1])
            del x, w
    return rec


def ssd_bound(b: int, s: int, h: int, p: int, n: int, q: int,
              mma: bool = True):
    """Least time for one SSD scan: x, a, B and C read once and y written
    once over HBM bandwidth; the visible work per (row, chunk) — causal
    scores (2 N per pair j <= i), scores times x (2 P per pair), the
    inter-chunk term and the state update (2 Q N P each) — at
    ``cost.bound_ms``'s rate for f32. (bytes ms, ops ms)."""
    return cost.bound_ms(*cost.ssd_scan(b, s, h, p, n, q), mma=mma)


def ssd_case(b: int, s: int, h: int, p: int, n: int, seed: int):
    """The JAX kernel test's inputs (tests/test_kernels.py:126-130): x
    normal, decays -softplus(normal), B and C normal at half scale."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g, device="cuda")
    a = -torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=g, device="cuda"))
    bm = torch.randn(b, s, h, n, generator=g, device="cuda") * 0.5
    cm = torch.randn(b, s, h, n, generator=g, device="cuda") * 0.5
    return x, a, bm, cm


def check_ssd(flush: torch.Tensor) -> dict:
    """The SSD scan against its plain version at mamba2-780m's and
    zamba2-7b's forward shapes, at a mamba2-780m rank's of the sharded
    phase's (1, 2) forward (24 of the 48 heads) and at edge shapes
    (tolerance 5e-4, tests/test_kernels.py:134's); time the three
    full-width calls (zamba2's and the rank's in ``other_shapes``)."""
    cases = [  # (B, S, H, P, N, chunk, what)
        (M2_B, M2_S, M2_H, M2_P, M2_N, M2_Q, "mamba2-780m forward"),
        (1, Z_S, Z_H, Z_P, Z_N, Z_Q, "zamba2-7b forward"),
        (1, M2_SHARD_S, M2_H // 2, M2_P, M2_N, M2_Q,
         "mamba2-780m sharded rank (1, 2)"),
        (2, 256, 16, 32, 16, 32, "smoke widths"),
        (2, 96, 4, M2_P, M2_N, M2_Q, "S 96: the chunk halves to 32"),
        (2, 64, 4, M2_P, M2_N, 128, "S 64 with chunk 128"),
        (2, 128, 8, M2_P, M2_N, 64, "a_log = -40 (memoryless)"),
        (1, 512, 1, M2_P, M2_N, M2_Q, "B = H = 1"),
    ]
    rec, others = None, []
    for (b, s, h, p, n, chunk, what) in cases:
        x, a, bm, cm = ssd_case(b, s, h, p, n, s + h + n)
        if "memoryless" in what:
            a = torch.full_like(a, -40.0)
        q = chunk
        while s % q:
            q //= 2
        out = ops.ssd_scan(x, a, bm, cm, chunk=chunk)
        err = _compare(f"ssd_scan [{b},{s},{h},{p}] N={n} chunk={chunk} "
                       f"(q={q}; {what})", out,
                       ssd.ssd_scan_plain(x, a, bm, cm, chunk=q),
                       torch.float32, tol=5e-4)
        if "memoryless" in what:
            want = (cm * bm).sum(-1, keepdim=True) * x
            _compare(f"ssd_scan {what} against (C.B) x", out, want,
                     torch.float32, tol=5e-4)
        if what == "mamba2-780m forward":
            ms = time_ms(lambda: ops.ssd_scan(x, a, bm, cm, chunk=q), flush)
            plain_ms = time_ms(
                lambda: ssd.ssd_scan_plain(x, a, bm, cm, chunk=q), flush,
                reps=10)
            print(f"ssd_scan {what}: kernel {ms:.4f} ms against the "
                  f"{SIMT_SSD_MS} ms of the SIMT kernel it replaced "
                  f"({SIMT_SSD_MS / ms:.2f}x)", flush=True)
            rec = _record(
                "ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:66",
                err, ms, plain_ms, *ssd_bound(b, s, h, p, n, q), None,
                dict(B=b, S=s, H=h, P=p, N=n, Q=q, dtype="float32"),
                ssd_bound(b, s, h, p, n, q, mma=False)[1])
        if what.startswith(("zamba2", "mamba2-780m sharded")):
            others.append(_record(
                "ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:66",
                err, time_ms(lambda: ops.ssd_scan(x, a, bm, cm, chunk=q),
                             flush),
                time_ms(lambda: ssd.ssd_scan_plain(x, a, bm, cm, chunk=q),
                        flush, reps=10),
                *ssd_bound(b, s, h, p, n, q), None,
                dict(path=what, B=b, S=s, H=h, P=p, N=n, Q=q,
                     dtype="float32")))
        del x, a, bm, cm, out
    rec["other_shapes"] = [{k: o[k] for k in SHAPE_KEYS} for o in others]
    return rec


# ---------------------------------------------------------------------------
# the backward kernels (no TPU kernel: the Pallas kernels have no backward)
# ---------------------------------------------------------------------------
#: their tolerances, on the largest error over the largest |gradient|
#: (tests/test_torch_cuda_kernels.py): flash's three TF32 passes against the
#: plain version's f32 einsums; the SSD scan at the forward's 5e-4 (sums of
#: a chunk's terms and the states' recurrence, in other orders)
FLASH_BWD_TOL, SSD_BWD_TOL = 2e-5, 5e-4


def _compare_grads(what: str, got, want, tol: float) -> float:
    """Each gradient's max abs error over its largest |value|; exits
    unless every one is within ``tol``. Returns the largest abs error."""
    torch.cuda.synchronize()
    errs, rels = [], []
    for g, w in zip(got, want):
        if g is None or g.shape != w.shape or not bool(
                torch.isfinite(g).all()):
            raise SystemExit(f"FAIL: {what}: a gradient is missing, "
                             f"misshapen or not finite")
        errs.append((g - w).abs().max().item())
        rels.append(errs[-1] / max(w.abs().max().item(), 1e-30))
    print(f"{what}: max_abs_err={max(errs):.3e}, relative to the largest "
          f"gradient {['%.2e' % r for r in rels]} (tol {tol})", flush=True)
    if max(rels) > tol:
        raise SystemExit(f"FAIL: {what} disagrees with autograd of its "
                         f"plain version")
    return max(errs)


def flash_bwd_bound(b: int, s: int, hq: int, hkv: int, d: int,
                    mma: bool = True, dtype=torch.float32):
    """Least time for one causal flash backward in ``dtype``: q, k, v, o, do
    read once and dq, dk, dv written once at its width, and the f32 row
    log-sum-exp read once, over HBM bandwidth; the five products of the
    visible pairs (scores, do.v, P^T do, dS^T q, dS k: 10 D flops a pair
    and q head) at ``cost.bound_ms``'s rate for the dtype (three TF32
    passes for f32, one bf16 pass). (bytes ms, ops ms)."""
    elem = torch.empty((), dtype=dtype).element_size()
    return cost.bound_ms(*cost.flash_attention_backward(b, s, hq, hkv, d,
                                                        elem),
                         f32=dtype is torch.float32, mma=mma)


def sdpa_backward(q, k, v, do):
    """One forward and autograd.grad of scaled_dot_product_attention
    (causal) on the same inputs: the library yardstick of the backward."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def run():
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
        return torch.autograd.grad(out, (qt, kt, vt), dot)
    return run


def check_flash_backward(flush: torch.Tensor) -> tuple:
    """The flash backward through ops.flash_attention's autograd Function
    against autograd of the plain version at phi-3-vision-4.2b's train
    step ([2, 1024, 32, 96], the kernels-line entries), olmoe-1b-7b's
    [1, 256, 16, 128] and whisper-large-v3's [1, 448, 20, 64] (causal),
    and at two GQA / window / ragged-S edges (D 64 and 128), each in f32
    (within FLASH_BWD_TOL of the largest |gradient|) and in bf16 (the
    plain version on the same inputs upcast to f32, within TOL's 2e-2);
    each model shape timed in both dtypes, with the forward's log-sum-exp
    as the autograd Function hands it over, beside its bound, the plain
    backward and SDPA's forward + backward in the same dtype. Returns the
    f32 and the bf16 kernels-line entries."""
    cases = [(SYN_B, PHI_S, PHI_H, PHI_H, PHI_D, 0,
              "phi-3-vision-4.2b train step"),
             (1, 256, OL_H, OL_H, OL_D, 0, "olmoe-1b-7b"),
             (1, W_S, W_H, W_H, W_D, 0, "whisper-large-v3"),
             (1, 200, 14, 2, 64, 5, "GQA 14/2, window 5, ragged S"),
             (1, 300, 16, 4, 128, 40, "D 128, GQA 16/4, window 40, ragged S")]
    recs = {torch.float32: [], torch.bfloat16: []}
    for (b, s, hq, hkv, d, window, what) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            g = torch.Generator(device="cuda").manual_seed(s + hq + d + 1)
            q, k, v = (torch.randn(b, s, h, d, generator=g,
                                   device="cuda").to(dtype)
                       for h in (hq, hkv, hkv))
            do = torch.randn(b, s, hq, d, generator=g,
                             device="cuda").to(dtype)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            ops.flash_attention(*leaves, window=window).backward(do)
            want = fa.flash_attention_backward_plain(
                *(t.float() for t in (q, k, v, do)), True, window)
            got = [t.grad for t in leaves]
            if any(t is None or t.dtype != dtype for t in got):
                raise SystemExit(f"FAIL: flash backward {what} {name}: a "
                                 f"gradient is missing or not {name}")
            err = _compare_grads(
                f"flash backward [{b}, {s}, {hq}/{hkv}, {d}] window="
                f"{window} {name} ({what})", [t.float() for t in got],
                want, FLASH_BWD_TOL if dtype is torch.float32
                else TOL[dtype])
            del leaves, want, got
            if window:
                continue
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
            r = _record(
                "flash_attention_backward" if dtype is torch.float32
                else "flash_attention_backward_bf16",
                "flash_attention_bwd.cu",
                "src/repro/kernels/flash_attention.py:86", err,
                time_ms(lambda: ops.flash_attention_backward(q, k, v, o, do,
                                                             lse=lse),
                        flush, reps=20),
                time_ms(lambda: fa.flash_attention_backward_plain(q, k, v,
                                                                  do),
                        flush, reps=5),
                *flash_bwd_bound(b, s, hq, hkv, d, dtype=dtype),
                time_ms(sdpa_backward(q, k, v, do), flush, reps=20),
                dict(path=what, B=b, S=s, Hq=hq, Hkv=hkv, D=d, causal=True,
                     window=0, dtype=name),
                flash_bwd_bound(b, s, hq, hkv, d, mma=False,
                                dtype=dtype)[1])
            r["note"] = (
                "the backward of flash_attention_bhsd, which has no TPU "
                "backward kernel; a dq and a dk/dv kernel on the forward's "
                "log-sum-exp, on the tensor cores: " +
                ("3xTF32" if dtype is torch.float32 else
                 "one bf16 m16n8k16 pass, f32 sums, P and dS rounded to "
                 "bf16"))
            recs[dtype].append(r)
            del q, k, v, o, lse, do
    out = []
    for rs in recs.values():
        rs[0]["other_shapes"] = [{k: r[k] for k in SHAPE_KEYS}
                                 for r in rs[1:]]
        out.append(rs[0])
    return tuple(out)


def ssd_bwd_bound(b: int, s: int, h: int, p: int, n: int, q: int,
                  mma: bool = True):
    """Least time for one SSD backward: x, a, B, C and dy read once, the
    forward's chunk states read once, and dx, da, dB and dC written once
    over HBM bandwidth; the function's own products at ``cost.bound_ms``'s rate
    for f32: C.B^T, dy.x^T, dx, dB and dC over each chunk's causal pairs
    (2 (3N + 2P) flops a pair), and the reversed state and the three inter
    terms (8 Q N P a chunk), a (row, chunk) each. (bytes ms, ops ms)."""
    return cost.bound_ms(*cost.ssd_scan_backward(b, s, h, p, n, q), mma=mma)


def ssd_backward_launches(fn) -> dict:
    """torch.profiler's count of the kernels one call of ``fn`` launches,
    by name (a marker kernel after it must be seen)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)                 # the marker: spin_kernel
        torch.cuda.synchronize()
        time.sleep(0.1)
    names = [ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.device_type() == torch.autograd.DeviceType.CUDA]
    if not any("spin_kernel" in n for n in names):
        raise SystemExit("FAIL: the profiler lost the SSD backward's marker")
    counts = {}
    for n in names:
        if "spin_kernel" not in n:
            key = n.replace("(anonymous namespace)::", "").split("(")[0]
            key = key[-60:]
            counts[key] = counts.get(key, 0) + 1
    return counts


def check_ssd_backward(flush: torch.Tensor) -> dict:
    """The SSD backward through ops.ssd_scan's autograd Function against
    autograd of the plain version at mamba2-780m's train step ([2, 4096],
    48 heads of 64, N 128: the kernels-line entry) and zamba2-7b's ([1,
    4096], 112 heads, N 64), timed with the forward's chunk states as the
    autograd Function hands them over, beside the bound and the plain
    backward (no PyTorch call computes it: no library time), and at the
    smoke widths and a chunk that halves. At mamba2's shape torch.profiler
    counts one call's kernels: the reversed states, their pass and the
    fused chunk pass, once each, and no ssd_scan_chunk_kernel (the
    forward's, which the backward never launches)."""
    cases = [(M2_B, M2_S, M2_H, M2_P, M2_N, M2_Q, "mamba2-780m train step"),
             (1, Z_S, Z_H, Z_P, Z_N, Z_Q, "zamba2-7b"),
             (2, 256, 16, 32, 16, 32, "smoke widths"),
             (2, 96, 4, M2_P, M2_N, M2_Q, "S 96: the chunk halves to 32")]
    rec, others = None, []
    for (b, s, h, p, n, chunk, what) in cases:
        x, a, bm, cm = ssd_case(b, s, h, p, n, s + h + n + 1)
        dy = torch.randn_like(x)
        q = chunk
        while s % q:
            q //= 2
        leaves = [t.clone().requires_grad_() for t in (x, a, bm, cm)]
        ops.ssd_scan(*leaves, chunk=chunk).backward(dy)
        want = ssd.ssd_scan_backward_plain(x, a, bm, cm, dy, chunk=q)
        err = _compare_grads(f"ssd_scan backward [{b}, {s}, {h}, {p}] N={n} "
                             f"q={q} ({what})", [t.grad for t in leaves],
                             want, SSD_BWD_TOL)
        del leaves, want
        if s < Z_S:
            continue
        _, states = ssd.ssd_scan_cuda(x, a, bm, cm, chunk=q,
                                      return_states=True)

        def bwd():
            return ops.ssd_scan_backward(x, a, bm, cm, dy, chunk=q,
                                         states=states)
        if rec is None:
            launched = ssd_backward_launches(bwd)
            print(f"ssd_scan backward kernels a call ({what}): {launched}",
                  flush=True)
            want = {"ssd_scan_state_kernel": 1, "ssd_scan_pass_kernel": 1,
                    "ssd_scan_bwd_chunk_kernel": 1,
                    "ssd_scan_chunk_kernel": 0}
            got = {k: sum(n for name, n in launched.items() if k in name)
                   for k in want}
            if sum(launched.values()) != 3 or got != want:
                raise SystemExit(f"FAIL: the SSD backward launched "
                                 f"{launched}: want the reversed states, "
                                 f"their pass and the fused chunk pass once "
                                 f"each, and no ssd_scan_chunk_kernel")
        r = _record(
            "ssd_scan_backward", "ssd_scan_bwd.cu",
            "src/repro/kernels/ssd_scan.py:66", err,
            time_ms(bwd, flush, reps=20),
            time_ms(lambda: ssd.ssd_scan_backward_plain(x, a, bm, cm, dy,
                                                        chunk=q),
                    flush, reps=5),
            *ssd_bwd_bound(b, s, h, p, n, q), None,
            dict(path=what, B=b, S=s, H=h, P=p, N=n, Q=q, dtype="float32"),
            ssd_bwd_bound(b, s, h, p, n, q, mma=False)[1])
        r["note"] = ("the backward of ssd_scan_bhsp, which has no TPU "
                     "backward kernel; tensor cores, 3xTF32: the reversed "
                     "chunk states, their pass from the last chunk down and "
                     "one fused chunk pass for dx, dB, dC and the decays' "
                     "gradient, on the training forward's chunk states")
        if rec is None:
            r["launches_per_call"] = launched
            rec = r
        else:
            others.append(r)
        del x, a, bm, cm, dy, states
    rec["other_shapes"] = [{k: r[k] for k in SHAPE_KEYS} for r in others]
    return rec


# ---------------------------------------------------------------------------
# reference: the card against the CPU at the smoke shape
# ---------------------------------------------------------------------------
def paged_logits(model, params, device):
    """Chained lane-batched prefill of two prompts through scattered block
    tables, then four decode steps; returns every logits tensor on the CPU."""
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, model.cfg.vocab_size, (n,), generator=g)
               for n in (40, 27)]
    cache = model.init_paged_cache(16, BS, device=device)
    tables = torch.tensor([[9, 2, 14, 5], [3, 11, 7, -1]], dtype=torch.int32)
    outs = []
    for r in range(3):
        tok = torch.zeros((2, BS), dtype=torch.int32)
        nv = torch.zeros((2,), dtype=torch.int32)
        tb = torch.full_like(tables, -1)
        for i, p in enumerate(prompts):
            n = max(0, min(BS, len(p) - r * BS))
            tok[i, :n], nv[i] = p[r * BS:r * BS + n], n
            if n:
                tb[i] = tables[i]
        start = torch.full((2,), r * BS, dtype=torch.int32)
        logits, cache, _ = model.paged_prefill_chunk(
            params, cache, tok.to(device), start.to(device), tb.to(device),
            n_valid=nv.to(device))
        outs.append(logits.cpu())
    tok = torch.tensor([[5], [7]], dtype=torch.int32)
    pos = torch.tensor([40, 27], dtype=torch.int32)
    for _ in range(4):
        logits, cache = model.paged_decode_step(
            params, cache, tok.to(device), pos.to(device), tables.to(device))
        outs.append(logits.cpu())
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32).cpu()
        pos += 1
    return outs


def moe_logits(model, params, device):
    """One-pass MoE forward over two prompts (the contiguous prefill, flash
    attention in every layer), its K/V written into a 3-row contiguous
    cache, then four decode steps with per-row positions (row 2 idle and
    frozen); returns every logits tensor on the CPU."""
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, model.cfg.vocab_size, (n,), generator=g,
                             dtype=torch.int32) for n in (37, 20)]
    cache = model.init_cache(3, 48, device=device)
    outs, tok = [], torch.zeros((3, 1), dtype=torch.int32)
    for i, p in enumerate(prompts):
        logits, (k, v) = moe.forward(model.cfg, params, p[None].to(device),
                                     return_cache=True)
        cache["k"][:, i, :len(p)] = k[:, 0]
        cache["v"][:, i, :len(p)] = v[:, 0]
        outs.append(logits.cpu())
        tok[i, 0] = int(logits[0, -1].argmax())
    pos = torch.tensor([37, 20, 0], dtype=torch.int32)
    valid = torch.tensor([True, True, False])
    for _ in range(4):
        logits, cache = model.decode_step(params, cache, tok.to(device),
                                          pos.to(device),
                                          write_valid=valid.to(device))
        outs.append(logits[:2].cpu())
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32).cpu()
        pos[:2] += 1
    return outs


def mamba2_logits(model, params, device):
    """The mamba2 forward over two 64-token rows (two chunks of 32: the scan
    kernel on the card), then the recurrent decode chain over the same
    tokens; returns every logits tensor on the CPU."""
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 64), generator=g,
                         dtype=torch.int32)
    outs = [model.forward(params, {"tokens": toks.to(device)}).cpu()]
    cache = model.init_cache(2, 64, device=device)
    for t in range(64):
        logits, cache = model.decode_step(params, cache,
                                          toks[:, t:t + 1].to(device), t)
        outs.append(logits.cpu())
    return outs


def zamba2_logits(model, params, device):
    """The hybrid forward over two 64-token rows (the scan kernel on the
    card in every Mamba2 block, the shared block on plain mha), then the
    decode chain over the same tokens (the shared block's K/V written at
    each position); returns every logits tensor on the CPU."""
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 64), generator=g,
                         dtype=torch.int32)
    outs = [model.forward(params, {"tokens": toks.to(device)}).cpu()]
    cache = model.init_cache(2, 64, device=device)
    for t in range(64):
        logits, cache = model.decode_step(params, cache,
                                          toks[:, t:t + 1].to(device), t)
        outs.append(logits.cpu())
    return outs


def whisper_logits(model, params, device):
    """The encoder-decoder forward over 64 frames and two 37-token rows
    (flash in every decoder layer on the card: a ragged S), then
    ``prefill_cross_kv`` and the decode chain over the same tokens;
    returns every logits tensor on the CPU."""
    g = torch.Generator().manual_seed(5)
    cfg = model.cfg
    toks = torch.randint(0, cfg.vocab_size, (2, 37), generator=g,
                         dtype=torch.int32)
    frames = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=g)
    outs = [model.forward(params, {"tokens": toks.to(device),
                                   "frames": frames.to(device)}).cpu()]
    cache = encdec.prefill_cross_kv(cfg, params, frames.to(device),
                                    model.init_cache(2, 37, device=device))
    for t in range(37):
        logits, cache = model.decode_step(params, cache,
                                          toks[:, t:t + 1].to(device), t)
        outs.append(logits.cpu())
    return outs


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


def check_reference() -> None:
    for arch, path, kw in (("qwen2-0.5b", paged_logits,
                            dict(decode_attention="paged")),
                           ("olmoe-1b-7b", moe_logits, {}),
                           ("mamba2-780m", mamba2_logits, {}),
                           ("zamba2-7b", zamba2_logits, {}),
                           ("zamba2-7b", zamba2_logits, dict(n_layers=5)),
                           ("whisper-large-v3", whisper_logits, {})):
        got = _check_reference(arch, path, **kw)
        if path is paged_logits or path is moe_logits:
            continue
        # the decode chain against the forward on the card (the check of
        # tests/test_smoke_archs.py:82-95)
        full, steps = got[0], torch.cat(got[1:], dim=1)
        gap = (steps - full).abs().max().item()
        what = f"{arch} smoke {kw or ''}"
        print(f"{what} on the card, {steps.shape[1]} decode steps vs "
              f"forward: max_abs_diff={gap:.3e} (tol 2e-3)", flush=True)
        if not torch.allclose(steps, full, atol=2e-3, rtol=1e-5):
            raise SystemExit(f"FAIL: the {what} decode chain disagrees with "
                             "its forward on the card")


def _check_reference(arch: str, path, **overrides) -> list:
    cfg = get_config(arch, smoke=True, **overrides)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    gpu = _to_cuda(cpu)
    with torch.inference_mode():
        ref = path(model, cpu, "cpu")
        got = path(model, gpu, "cuda")
    # float32 on both, different summation orders (cuBLAS vs CPU BLAS, the
    # kernels' online softmax vs the plain versions' single pass): logits
    # agree to ~1e-5; 1e-3 leaves margin without hiding a wrong mask.
    worst = max((a - b).abs().max().item() for a, b in zip(ref, got))
    print(f"{arch} smoke {overrides or ''}, card vs CPU, {len(ref)} logits "
          f"tensors: max_abs_diff={worst:.3e} (tol 1e-3)", flush=True)
    if not all(torch.allclose(a, b, atol=1e-3, rtol=1e-3)
               for a, b in zip(ref, got)):
        raise SystemExit(f"FAIL: the card's {arch} path disagrees with the "
                         "CPU")
    return got


# ---------------------------------------------------------------------------
# engines: captured, eager and replayed runs of one request set
# ---------------------------------------------------------------------------
#: the three runs of every engine phase, in order: "captured" (the main
#: path's run: each static signature's first call eager, then captured;
#: the kernels line reads its launches), "eager" (under graphs.eager(): no
#: graph at all) and "replayed" (every signature captured already)
MODES = ("captured", "eager", "replayed")
#: ServeStats fields that are wall-clock times (``decode_util`` a measured
#: ratio over them); every other is a counter
TIMES = {"wall_s", "tokens_per_s", "mean_latency_s", "prefill_s",
         "decode_s", "decode_util"}
COUNTER_NAMES = tuple(f.__name__ for f, _ in ops.COUNTERS)


def _mode(mode: str):
    return graphs.eager() if mode == "eager" else contextlib.nullcontext()


def serve_modes(engine, args, what: str, make=None) -> dict:
    """Serve ``args``' request set (``make()``'s when given) on ``engine``
    once per mode (``MODES``), every launch counter set to 0 just before
    each run and read just after. Fails unless the three runs give the same
    tokens, counters and launches, and unless the replayed run captured
    nothing new. Prints one line a run and returns {mode: dict(out, stats,
    launches, replays)}."""
    make = make or (lambda: serve_cli.requests(args))
    res = {}
    for mode in MODES:
        reqs = make()
        ops.set_counts((0,) * len(ops.COUNTERS))
        replays, keys = engine.graphs.replays, len(engine.graphs.keys)
        torch.cuda.synchronize()
        with _mode(mode):
            out, stats = engine.run(reqs)
        torch.cuda.synchronize()
        launches = dict(zip(COUNTER_NAMES, ops.counts()))
        res[mode] = dict(out=out, stats=stats, launches=launches,
                         replays=engine.graphs.replays - replays,
                         captured=len(engine.graphs.keys) - keys)
        prompt_tokens = sum(len(r.prompt) for r in out)
        print(json.dumps({"serve": what, "mode": mode, **{
            k: getattr(stats, k) for k in (
                "wall_s", "tokens_per_s", "prefill_s", "decode_s",
                "prefill_dispatches", "decode_dispatches", "steps",
                "host_syncs")},
            "decode_ms_per_step": 1e3 * stats.decode_s / stats.steps,
            "prefill_ms_per_dispatch":
                1e3 * stats.prefill_s / stats.prefill_dispatches,
            "prefill_ms_per_token": 1e3 * stats.prefill_s / prompt_tokens,
            "graphs_captured": res[mode]["captured"],
            "graph_replays": res[mode]["replays"],
            "launches": {k: v for k, v in launches.items() if v}}),
            flush=True)
    base = res["captured"]
    counters = [f.name for f in dataclasses.fields(base["stats"])
                if f.name not in TIMES]
    for mode in MODES[1:]:
        r = res[mode]
        if [x.output for x in r["out"]] != [x.output for x in base["out"]]:
            raise SystemExit(f"FAIL: {what}: the {mode} run's tokens differ "
                             "from the captured run's")
        diff = [n for n in counters
                if getattr(r["stats"], n) != getattr(base["stats"], n)]
        if diff or r["launches"] != base["launches"]:
            raise SystemExit(f"FAIL: {what}: the {mode} run differs from the "
                             f"captured run in {diff} / launches "
                             f"{r['launches']} vs {base['launches']}")
    if (res["eager"]["replays"] or not base["replays"]
            or not res["replayed"]["replays"] or res["replayed"]["captured"]):
        raise SystemExit(f"FAIL: {what}: replays "
                         f"{[res[m]['replays'] for m in MODES]}, captured "
                         f"{[res[m]['captured'] for m in MODES]}")
    print(f"{what}: captured, eager and replayed runs agree in tokens, "
          f"{len(counters)} counters and launches; graph signatures "
          f"{sorted(engine.graphs.keys, key=str)}", flush=True)
    return res


def _check_outputs(what: str, engine, out, max_new: int) -> None:
    vocab = engine.cfg.vocab_size
    for r in out:
        if len(r.output) != max_new or not all(0 <= t < vocab
                                               for t in r.output):
            raise SystemExit(f"FAIL: {what}: request {r.job_id} holds "
                             f"{r.output}")


def _kinds(engine) -> set:
    return {k[0] for k in engine.graphs.keys}


def qwen2_engine_cfg():
    """qwen2-0.5b at full width, ``Q_ENGINE_LAYERS`` deep."""
    return get_config("qwen2-0.5b").replace(n_layers=Q_ENGINE_LAYERS)


def run_engine(summary: dict) -> tuple:
    """The full-width qwen2-0.5b paged engine (module docstring, phases 5
    and 6): ``run_paged_engine`` with a replayed and an eager profile,
    then the sampled phase. Returns each paged kernel's launches in the
    captured run, the engine's weights and its three runs' results."""
    args = serve_cli.build_parser().parse_args(ENGINE_ARGS)
    what = "qwen2-0.5b paged"
    engine, res, launches = run_paged_engine(summary, args, what, None,
                                             modes=("replayed", "eager"),
                                             cfg=qwen2_engine_cfg())
    phase("sampled")
    summary[what]["sampled_vs_greedy"] = run_sampled(engine)
    params = engine.params
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches, params, res


def chaos_engine(cfg, params, device, faults: bool = True, tracer=None):
    """The chaos phase's engine on ``params`` and a function that makes
    its request set anew (module docstring, chaos): two tenants,
    SLO-slack order and an allocation planned on the analytic profile;
    with ``faults``, ``CHAOS_FAULTS`` and an elastic controller; with
    ``tracer``, its events."""
    def make():
        return philly_requests(
            cfg.vocab_size, tenant_of=lambda job: (
                "batch" if job.gpu_demand > 1 else "interactive"),
            **CHAOS_REQS)
    registry = TenantRegistry([Tenant("interactive", weight=2.0,
                                      slo_steps=64.0), Tenant("batch")])
    profiles = profiles_from_requests(
        registry, make(), total_units=CHAOS_BLOCKS, max_k=8,
        units_for=lambda r: -(-(len(r.prompt) + r.max_new_tokens) // BS))
    allocation = plan_allocation(registry, profiles, CHAOS_BLOCKS,
                                 total_lanes=4, max_k=8,
                                 watermark_units=-(-CHAOS_BLOCKS // 20))
    kw = {}
    if faults:
        kw = dict(injector=FaultInjector(FaultSchedule.from_spec(
            CHAOS_FAULTS)), elastic=ElasticController())
    engine = ServeEngine(cfg, params=params, max_len=CHAOS_REQS["max_len"],
                         n_slots=SLOTS, policy="slo", cache="paged",
                         block_size=BS, n_blocks=CHAOS_BLOCKS,
                         prefill_lanes=4, decode_horizon=8,
                         tenants=registry, allocation=allocation,
                         tracer=tracer, device=device, **kw)
    return engine, make


def _chaos_record(engine, out, stats) -> dict:
    """What the chaos phase's runs must share: tokens, the injected faults,
    the dropped ids and causes, each request's retries and preemptions,
    every ServeStats counter (the per-tenant block without its wall-clock
    entries)."""
    counters = {f.name: getattr(stats, f.name)
                for f in dataclasses.fields(stats) if f.name not in TIMES}
    counters["tenants"] = {
        tid: {k: v for k, v in d.items() if not k.endswith("_s")}
        for tid, d in (stats.tenants or {}).items()}
    return dict(tokens=[r.output for r in out],
                budgets=[r.max_new_tokens for r in out],
                injected=list(engine.injector.injected),
                dropped=[(r.job_id, r.drop_cause) for r in out if r.dropped],
                requeued=[(r.n_retries, r.n_preempted) for r in out],
                counters=counters)


def chaos_runs(engine, make) -> dict:
    """Serve the chaos set once per mode (``MODES``) on one engine, every
    launch counter 0 before each run and read after; the first run also
    checks each growth's new pools against the old ones (``torch.equal``
    on the leading slice). Fails unless the runs agree in their records
    and launches, the pool audits clean after each, and the captured and
    replayed runs replayed graphs. Every run here ends with a grown pool,
    so the next one starts from a new pool and no graph: the "replayed"
    run captures its signatures again, as the captured run does (ROADMAP
    B9); ``first_calls`` counts them. Returns {mode: dict(record, stats,
    launches, replays, first_calls, migrations)}."""
    cuda = engine.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    grown, pending = [], []
    grow = BlockManager.grow_physical
    drop_graphs = engine.graphs.reset

    def keep_old(pool, n):
        # references only: the engine times grow_physical and its sync,
        # then drops the graphs, where the comparison runs outside the timer
        pending.append((pool, pool.buffers))
        return grow(pool, n)

    def check_then_drop():
        while pending:
            pool, old = pending.pop()
            nb = old["k"].shape[1]
            grown.append(all(torch.equal(pool.buffers[name][:, :nb],
                                         old[name]) for name in ("k", "v")))
        drop_graphs()

    res = {}
    for mode in MODES:
        reqs = make()
        ops.set_counts((0,) * len(ops.COUNTERS))
        replays = engine.graphs.replays
        sync()
        if mode == MODES[0]:
            BlockManager.grow_physical = keep_old
            engine.graphs.reset = check_then_drop
        try:
            with _mode(mode):
                out, stats = engine.run(reqs)
        finally:
            BlockManager.grow_physical = grow
            engine.graphs.reset = drop_graphs
        if pending:
            raise SystemExit("FAIL: chaos: a growth's pools were never "
                             "compared")
        sync()
        launches = dict(zip(COUNTER_NAMES, ops.counts()))
        audit = engine.pool.audit()
        # the run started with no graph: the previous run grew its pool
        first_calls = len(engine.graphs.keys) + sum(
            m["graphs_dropped"] for m in engine.migrations)
        res[mode] = dict(record=_chaos_record(engine, out, stats),
                         stats=stats, launches=launches,
                         replays=engine.graphs.replays - replays,
                         first_calls=first_calls,
                         migrations=list(engine.migrations))
        print(json.dumps({"chaos": mode, **{k: getattr(stats, k) for k in (
            "wall_s", "tokens_per_s", "n_requests", "new_tokens", "steps",
            "decode_dispatches", "prefill_dispatches", "faults_injected",
            "recoveries", "dropped", "preemptions", "scale_ups",
            "scale_downs", "migrated_blocks", "replans")},
            "decode_ms_per_step": 1e3 * stats.decode_s / stats.steps,
            "prefill_ms_per_round":
                1e3 * stats.prefill_s / stats.prefill_dispatches,
            "injected": engine.injector.injected,
            "dropped_ids": res[mode]["record"]["dropped"],
            "migrations": [{k: m[k] for k in ("step", "blocks", "added",
                                              "bytes", "graphs_dropped")}
                           | {"ms": 1e3 * m["dur_s"]}
                           for m in engine.migrations],
            "graph_signatures": len(engine.graphs.keys),
            "graph_first_calls": first_calls,
            "graph_replays": res[mode]["replays"], "audit": audit,
            "launches": {k: v for k, v in launches.items() if v}}),
            flush=True)
    base = res[MODES[0]]
    for mode in MODES[1:]:
        r = res[mode]
        diff = [k for k in base["record"]
                if r["record"][k] != base["record"][k]]
        if diff or r["launches"] != base["launches"]:
            raise SystemExit(f"FAIL: chaos: the {mode} run differs from the "
                             f"captured run in {diff} / launches "
                             f"{r['launches']} vs {base['launches']}")
    if (res["eager"]["replays"] or not base["replays"]
            or not res["replayed"]["replays"]):
        raise SystemExit(f"FAIL: chaos: replays "
                         f"{[res[m]['replays'] for m in MODES]}")
    if not grown or not all(grown):
        raise SystemExit(f"FAIL: chaos: grow_physical's new pools hold the "
                         f"old blocks: {grown}")
    print(f"chaos: captured, eager and replayed runs agree in tokens, "
          f"faults, drops and {len(base['record']['counters'])} counters "
          f"and launches; {len(grown)} growth(s) kept every block "
          f"(torch.equal); the replayed run recaptured "
          f"{res['replayed']['first_calls']} signatures (its pool was new) "
          f"and replayed {res['replayed']['replays']} times", flush=True)
    return res


def run_chaos(summary: dict, params) -> dict:
    """The chaos phase (module docstring) on the engine phase's
    weights. Returns each paged kernel's launches in the captured run and
    that run's result (``chaos_runs``)."""
    cfg = qwen2_engine_cfg()
    engine, make = chaos_engine(cfg, params, "cuda")
    res = chaos_runs(engine, make)
    base = res["captured"]
    rec, stats, counts = base["record"], base["stats"], base["launches"]
    kinds = {k for k, _ in rec["injected"]}
    launches = {"paged_decode": counts["paged_attention"],
                "paged_prefill": counts["paged_prefill_attention"]}
    plain_calls = sum(v for k, v in counts.items() if k.endswith("_plain"))
    # a dropped request holds no token, every other its whole budget
    dropped = {jid for jid, _ in rec["dropped"]}
    out_ok = all(
        (not t) if i in dropped else (
            len(t) == n and all(0 <= x < cfg.vocab_size for x in t))
        for i, (t, n) in enumerate(zip(rec["tokens"], rec["budgets"])))
    if (min(launches.values()) <= 0 or plain_calls
            or counts["flash_attention"] or not out_ok):
        raise SystemExit(f"FAIL: chaos: launches {launches}, plain calls "
                         f"{plain_calls}, flash {counts['flash_attention']},"
                         f" outputs ok {out_ok}")
    if (not {"pool_shrink", "slot_kill", "tenant_slowdown", "arrival_burst",
             "prefix_flush", "defer_storm", "device_fail",
             "device_join"} <= kinds or not stats.migrated_blocks
            or not stats.scale_downs):
        raise SystemExit(f"FAIL: chaos: faults {rec['injected']}, migrated "
                         f"{stats.migrated_blocks}, scale-downs "
                         f"{stats.scale_downs}")
    # every request not dropped against the fault-free static contiguous
    # engine at K=1 on the same weights
    replay = run_replay(engine, make(), verify=True, ref_cfg=cfg)
    print(json.dumps({"chaos_verify": {
        "verified": replay.verified, "mismatched": replay.mismatched,
        "scored": len(replay.requests) - len(replay.dropped),
        "dropped": replay.dropped}}), flush=True)
    if not replay.verified:
        raise SystemExit(f"FAIL: chaos: requests {replay.mismatched} differ "
                         "from the fault-free static contiguous engine")
    # the same request set without faults, beside the engine phase's step
    free, _ = chaos_engine(cfg, params, "cuda", faults=False)
    for _ in range(2):                       # capture, then replay
        out, free_stats = free.run(make())
    same = sum(o.output == t for o, t in zip(out, rec["tokens"]))
    # the "replayed" mode's run starts from no graph and recaptures every
    # signature (chaos_runs): its figures are a recapture run's
    again = res["replayed"]
    rec = {"recapture_run": {
               "wall_s": again["stats"].wall_s,
               "first_calls": again["first_calls"],
               "replays": again["replays"],
               **_per_step(again["stats"])},
           "fault_free_decode_ms_per_step":
               1e3 * free_stats.decode_s / free_stats.steps,
           "fault_free_wall_s": free_stats.wall_s,
           "fault_free_tokens_equal": f"{same} of {len(out)}",
           "engine_phase_decode_ms_per_step":
               summary["qwen2-0.5b paged"]["replayed"]["decode_ms_per_step"],
           "migrations": {mode: [
               {"ms": 1e3 * m["dur_s"], "bytes": m["bytes"],
                "blocks": m["blocks"], "added": m["added"],
                "graphs_dropped": m["graphs_dropped"]}
               for m in res[mode]["migrations"]] for mode in MODES},
           "graph_signatures_after": len(engine.graphs.keys)}
    print(json.dumps({"chaos_summary": rec}), flush=True)
    summary["qwen2-0.5b chaos"] = rec
    del engine, free
    gc.collect()
    torch.cuda.empty_cache()
    return launches, base


#: the obs phase's files (build/ is git-ignored)
OBS_DIR = os.path.join(ROOT, "build", "obs")
#: the settings whose cost the obs phase measures: (name, tracer attached,
#: profiler attached)
OBS_SETTINGS = (("both", True, True), ("neither", False, False),
                ("profiler alone", False, True), ("tracer alone", True, False))
#: how many replayed runs of each setting, in rotated order
OBS_REPEATS = 3
#: the obs phase's runs: (name, graph mode, tracer attached, profiler
#: attached); every run but the first replays the first's graphs; after
#: the captured and the first replayed run, OBS_REPEATS rounds of every
#: setting, each round's order rotated by one (a Latin square)
OBS_RUNS = (("captured", "captured", True, True),
            ("replayed", "replayed", True, True)) + tuple(
    (f"{OBS_SETTINGS[(i + j) % len(OBS_SETTINGS)][0]} {i}", "replayed",
     *OBS_SETTINGS[(i + j) % len(OBS_SETTINGS)][1:])
    for i in range(OBS_REPEATS) for j in range(len(OBS_SETTINGS)))
#: event fields that hold wall times (``util`` a ratio over one)
EVENT_TIMES = ("t", "wall_s", "dur_s", "util")
#: the chaos events held equal between graph and eager runs (those of
#: tests/test_chaos.py:281-297, and the reshapes')
CHAOS_EVENTS = ("fault_inject", "recover", "admit", "preempt", "evict",
                "defer", "migrate", "scale_up", "scale_down")
#: the most a dispatch's roofline share may read: above 1 the timer missed
#: device work
UTIL_MAX = 1.05


def _untimed(events, drop=EVENT_TIMES) -> list:
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


def _by_phase(records) -> dict:
    """Per phase of one run's profiler records: dispatches, compiles,
    compile and execute seconds, mean / min / max util of the executes,
    and their mean util with the FLOPs term at the f32 rate outside the
    tensor cores (the engine's GEMMs run there, TF32 off) with the count
    of executes that term binds."""
    out = {}
    for r in records:
        p = out.setdefault(r["phase"], dict(dispatches=0, compiles=0,
                                            compile_s=0.0, execute_s=0.0,
                                            utils=[], utils_f32=[],
                                            flops_bound_f32=0))
        p["dispatches"] += 1
        if r["compile"]:
            p["compiles"] += 1
            p["compile_s"] += r["dur_s"]
        else:
            p["execute_s"] += r["dur_s"]
            p["utils"].append(r["util"])
            flop_s, byte_s = r["flops"] / F32_FLOPS, r["hbm_bytes"] / HBM_BPS
            p["utils_f32"].append(max(flop_s, byte_s) / r["dur_s"])
            p["flops_bound_f32"] += flop_s > byte_s
    for p in out.values():
        u, u32 = p.pop("utils"), p.pop("utils_f32")
        p.update(mean_util=sum(u) / len(u) if u else None,
                 min_util=min(u, default=None), max_util=max(u, default=None),
                 mean_util_f32=sum(u32) / len(u32) if u32 else None)
    return out


def obs_runs(engine, args, tracer, prof) -> dict:
    """Serve ``args``' request set once per ``OBS_RUNS`` entry on
    ``engine``, attaching ``tracer`` and ``prof`` as it says, every launch
    counter 0 just before each run and read just after. Returns {name:
    dict(out, stats, launches, events, records)}, each run's own events
    and records."""
    res = {}
    sync = torch.cuda.synchronize
    for name, mode, traced, profiled in OBS_RUNS:
        engine.tracer = tracer if traced else NULL_TRACER
        engine.profiler = prof if profiled else NULL_PROFILER
        n_events, n_records = len(tracer), len(prof.records)
        reqs = serve_cli.requests(args)
        ops.set_counts((0,) * len(ops.COUNTERS))
        sync()
        with _mode(mode):
            out, stats = engine.run(reqs)
        sync()
        res[name] = dict(out=out, stats=stats,
                         launches=dict(zip(COUNTER_NAMES, ops.counts())),
                         events=tracer.events[n_events:],
                         records=prof.records[n_records:])
        print(json.dumps({
            "obs": name, "traced": traced, "profiled": profiled,
            **{k: getattr(stats, k) for k in (
                "wall_s", "tokens_per_s", "decode_util",
                "decode_dispatches", "prefill_dispatches")},
            "events": len(res[name]["events"]),
            "by_phase": _by_phase(res[name]["records"])}), flush=True)
    engine.tracer, engine.profiler = tracer, prof
    return res


def check_obs_run(name: str, r: dict, untraced: dict, traced: bool,
                  profiled: bool) -> None:
    """One obs run against the untraced run of its graph mode: tokens,
    every ServeStats counter, every launch count; its events (schema, one
    span a dispatch) and its records (one a dispatch, each execute's util
    in (0, UTIL_MAX])."""
    st, base = r["stats"], untraced["stats"]
    diff = [f.name for f in dataclasses.fields(st) if f.name not in TIMES
            and getattr(st, f.name) != getattr(base, f.name)]
    same = ([x.output for x in r["out"]]
            == [x.output for x in untraced["out"]])
    if (not same or diff or r["launches"] != untraced["launches"]
            or min(r["launches"][k] for k in ("paged_attention",
                                              "paged_prefill_attention"))
            <= 0):
        raise SystemExit(f"FAIL: obs {name}: tokens equal {same}, counters "
                         f"differ {diff}, launches {r['launches']} vs "
                         f"{untraced['launches']}")
    n_disp = st.decode_dispatches + st.prefill_dispatches
    evs = r["events"]
    kinds = [e["ev"] for e in evs]
    if traced and (validate_events(evs)
                   or kinds.count("decode_horizon") != st.decode_dispatches
                   or kinds.count("prefill_round") != st.prefill_dispatches
                   or kinds.count("run_start") != 1
                   or kinds.count("dispatch_profile") != n_disp * profiled):
        raise SystemExit(f"FAIL: obs {name}: events "
                         f"{validate_events(evs)[:5]}, "
                         f"{ {k: kinds.count(k) for k in set(kinds)} } for "
                         f"{st.decode_dispatches} decode and "
                         f"{st.prefill_dispatches} prefill dispatches")
    if traced != bool(evs):
        raise SystemExit(f"FAIL: obs {name}: {len(evs)} events")
    recs = r["records"]
    bad = [rec for rec in recs if not rec["compile"]
           and not (rec["util"] is not None and 0 < rec["util"] <= UTIL_MAX)]
    if len(recs) != n_disp * profiled or bad:
        raise SystemExit(f"FAIL: obs {name}: {len(recs)} records for "
                         f"{n_disp} dispatches; utils out of (0, "
                         f"{UTIL_MAX}]: {bad[:5]}")


def check_chrome(events, path: str) -> dict:
    """Write the Chrome trace and read it back: a track for each span type
    present and a util counter for each profiled phase."""
    write_chrome_trace(path, events)
    with open(path) as f:
        doc = json.load(f)
    tracks = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    spans = {tracks[e["tid"]] for e in doc["traceEvents"] if e["ph"] == "X"}
    counters = {e["name"] for e in doc["traceEvents"] if e["ph"] == "C"}
    if (spans != {"prefill", "decode"}
            or counters != {"util[decode]", "util[prefill_round]"}
            or doc != json.loads(json.dumps(to_chrome_trace(events)))):
        raise SystemExit(f"FAIL: obs: Chrome trace span tracks {spans}, "
                         f"counters {counters}")
    return {"path": os.path.relpath(path, ROOT),
            "trace_events": len(doc["traceEvents"]),
            "span_tracks": sorted(spans), "counters": sorted(counters)}


def profiling_cost(res: dict) -> dict:
    """Per ``OBS_SETTINGS`` entry, its replayed runs' tokens/s (in run
    order), their median, their spread ((max - min) / median) and the
    median's change against the median with neither attached."""
    out = {}
    for setting, *_ in OBS_SETTINGS:
        tps = [res[f"{setting} {i}"]["stats"].tokens_per_s
               for i in range(OBS_REPEATS)]
        med = statistics.median(tps)
        out[setting] = {"runs": tps, "median": med,
                        "spread": (max(tps) - min(tps)) / med}
    for setting in out:
        out[setting]["vs_neither"] = (out[setting]["median"]
                                      / out["neither"]["median"] - 1)
    return out


def run_obs(summary: dict, params, untraced: dict, chaos: dict) -> dict:
    """The obs phase (module docstring) on the engine phase's weights;
    ``untraced`` the engine phase's runs, ``chaos`` the chaos phase's
    captured run. Returns each paged kernel's launches in the captured
    traced run."""
    os.makedirs(OBS_DIR, exist_ok=True)
    jsonl, chrome, store_path = (os.path.join(OBS_DIR, f) for f in (
        "trace.jsonl", "trace.json", "profiles_torch.jsonl"))
    if os.path.exists(store_path):
        os.remove(store_path)               # this run's records only
    args = serve_cli.build_parser().parse_args(ENGINE_ARGS + [
        "--trace", jsonl, "--profile", "--profile-store", store_path])
    engine, _, _ = serve_cli.build(args, params=params,
                                   cfg=qwen2_engine_cfg())
    tracer, prof = engine.tracer, engine.profiler
    res = obs_runs(engine, args, tracer, prof)
    for name, mode, traced, profiled in OBS_RUNS:
        check_obs_run(name, res[name], untraced[mode], traced, profiled)
    if tracer.dropped:
        raise SystemExit(f"FAIL: obs: the ring dropped {tracer.dropped}")
    captured, replayed = (_untimed(res[m]["events"],
                                   EVENT_TIMES + ("compile",))
                          for m in ("captured", "replayed"))
    if captured != replayed:
        i = next(i for i, (a, b) in enumerate(zip(captured + [None],
                                                  replayed + [None]))
                 if a != b)
        raise SystemExit(f"FAIL: obs: the replayed run's events differ from "
                         f"the captured run's at {i}: {captured[i:i + 1]} "
                         f"vs {replayed[i:i + 1]}")
    compiles = [sum(r["compile"] for r in res[m]["records"])
                for m, *_ in OBS_RUNS]
    if compiles[0] != len(engine.graphs.keys) or any(compiles[1:]):
        raise SystemExit(f"FAIL: obs: compiles by run {compiles}, graph "
                         f"signatures {len(engine.graphs.keys)}")
    # the CLI's summary: writes the JSONL trace, folds the profile into the
    # store and saves it
    last = res[OBS_RUNS[-1][0]]
    record = serve_cli.summary(args, engine, last["out"], last["stats"])
    events = load_trace(jsonl)
    report = trace_report.build_report(events)
    costs = {row["phase"]: row for row in report["phase_costs"]}
    traced_runs = [res[m] for m, _, traced, _ in OBS_RUNS if traced]
    if (validate_events(events[1:]) or costs["decode"]["count"] != sum(
            r["stats"].decode_dispatches for r in traced_runs)
            or costs["prefill_round"]["count"] != sum(
                r["stats"].prefill_dispatches for r in traced_runs)):
        raise SystemExit(f"FAIL: obs: the report's phase costs {costs}")
    chrome_rec = check_chrome(tracer.events, chrome)
    store = engine.profile_store
    fit = store.rate_fit("qwen2-0.5b", "paged")
    upr = -(-(args.prompt_len + args.shared_prefix + args.max_new) // BS)
    cls = profile_class("qwen2-0.5b", units_per_req=upr,
                        concurrency=args.batch, total_units=NB, max_k=8,
                        store=store, arch="qwen2-0.5b", backend="paged")
    if (cls.source == "measured") != (fit is not None):
        raise SystemExit(f"FAIL: obs: profile_class source {cls.source}, "
                         f"fit {fit}")
    rec = {"by_run": {m: _by_phase(res[m]["records"])
                      for m in ("captured", "replayed")},
           "tokens_per_s": profiling_cost(res),
           "untraced_engine_phase_replayed_tokens_per_s":
               untraced["replayed"]["stats"].tokens_per_s,
           "profile_summary": record["profile"],
           "rate_fit": {"t_tok": fit[0], "t_fixed": fit[1]} if fit else None,
           "profile_class": {"source": cls.source, "t_tok": cls.t_tok,
                             "t_fixed": cls.t_fixed},
           "events": {"captured": len(res["captured"]["events"]),
                      "replayed": len(res["replayed"]["events"])},
           "report_phase_costs": report["phase_costs"],
           "chrome": chrome_rec}
    print(json.dumps({"obs_summary": rec}), flush=True)
    counts = res["captured"]["launches"]
    launches = {"paged_decode": counts["paged_attention"],
                "paged_prefill": counts["paged_prefill_attention"]}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    rec["chaos"] = traced_chaos(params, chaos)
    summary["qwen2-0.5b traced"] = rec
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def traced_chaos(params, chaos: dict) -> dict:
    """The chaos set with a tracer, graphs then eager, on a new engine: the
    ``CHAOS_EVENTS`` of the two runs (times dropped) must be equal, and
    each run's record and launches the chaos phase's captured run's."""
    cfg = qwen2_engine_cfg()
    engine, make = chaos_engine(cfg, params, "cuda", tracer=Tracer())
    got = {}
    for mode in ("replayed", "eager"):
        engine.tracer = tracer = Tracer()
        ops.set_counts((0,) * len(ops.COUNTERS))
        with _mode(mode):
            out, stats = engine.run(make())
        torch.cuda.synchronize()
        launches = dict(zip(COUNTER_NAMES, ops.counts()))
        record = _chaos_record(engine, out, stats)
        diff = [k for k in record if record[k] != chaos["record"][k]]
        events = tracer.events
        if (diff or launches != chaos["launches"] or tracer.dropped
                or validate_events(events)):
            raise SystemExit(f"FAIL: obs chaos {mode}: differs from the "
                             f"chaos phase in {diff}, launches {launches} vs "
                             f"{chaos['launches']}, dropped {tracer.dropped},"
                             f" schema {validate_events(events)[:5]}")
        got[mode] = _untimed([e for e in events if e["ev"] in CHAOS_EVENTS])
    if got["replayed"] != got["eager"]:
        raise SystemExit("FAIL: obs chaos: the graph and eager runs' events "
                         "differ")
    kinds = [e["ev"] for e in got["eager"]]
    rec = {k: kinds.count(k) for k in CHAOS_EVENTS}
    if not all(rec[k] for k in ("fault_inject", "recover", "preempt",
                                "migrate", "scale_up", "scale_down")):
        raise SystemExit(f"FAIL: obs chaos: events {rec}")
    print(json.dumps({"obs_chaos": {"equal_graph_eager": True, **rec}}),
          flush=True)
    del engine
    return rec


def _summary(res: dict) -> dict:
    """Per mode: tokens/s, decode ms a step, prefill ms a dispatch and a
    prompt token."""
    rec = {}
    for mode, r in res.items():
        st = r["stats"]
        toks = sum(len(x.prompt) for x in r["out"])
        rec[mode] = {"tokens_per_s": st.tokens_per_s,
                     "decode_ms_per_step": 1e3 * st.decode_s / st.steps,
                     "prefill_ms_per_dispatch":
                         1e3 * st.prefill_s / st.prefill_dispatches,
                     "prefill_ms_per_token": 1e3 * st.prefill_s / toks}
    return rec


def _per_step(stats) -> dict:
    return {"prefill_ms_per_round":
                1e3 * stats.prefill_s / stats.prefill_dispatches,
            "decode_ms_per_step": 1e3 * stats.decode_s / stats.steps}


def run_sampled(greedy) -> dict:
    """qwen2-0.5b paged at temperature 0.8, top-k 50 on ``SAMPLED_ARGS``'
    request set: a new engine serves it three times (capture, then
    replays), which must draw the same tokens. Between its replays the
    greedy engine ``greedy`` serves the same set (after a run that captures
    its signatures), so the sampled pick's cost a prefill round and a
    decode step shows beside greedy's in one call. Returns the replayed
    runs' times, per kind."""
    args = serve_cli.build_parser().parse_args(SAMPLED_ARGS + [
        "--temperature", "0.8", "--top-k", "50"])
    greedy_args = serve_cli.build_parser().parse_args(SAMPLED_ARGS)
    engine, _, _ = serve_cli.build(args, cfg=qwen2_engine_cfg())
    greedy.run(serve_cli.requests(greedy_args))
    runs, times = [], {"sampled": [], "greedy": []}
    for kind in ("sampled", "sampled", "greedy", "sampled", "greedy"):
        if kind == "sampled":
            out, stats = engine.run(serve_cli.requests(args))
            runs.append([r.output for r in out])
            _check_outputs("sampled", engine, out, args.max_new)
        else:
            out, stats = greedy.run(serve_cli.requests(greedy_args))
        if len(runs) > 1 or kind == "greedy":      # not the capturing run
            times[kind].append(_per_step(stats))
    print(json.dumps({"sampled": {
        "temperature": args.temperature, "top_k": args.top_k,
        "requests": args.batch, "max_new": args.max_new,
        "prefill_dispatches": stats.prefill_dispatches, "steps": stats.steps,
        "graph_replays": engine.graphs.replays,
        "sample_output": runs[0][0][:8], **times}}), flush=True)
    if any(r != runs[0] for r in runs) or not engine.graphs.replays:
        raise SystemExit("FAIL: three sampled runs drew different tokens")
    print("sampled qwen2 run repeated exactly", flush=True)
    return times


def olmoe_engine_cfg():
    """olmoe-1b-7b at full width, ``OL_ENGINE_LAYERS`` deep."""
    return get_config("olmoe-1b-7b").replace(n_layers=OL_ENGINE_LAYERS)


def run_olmoe(summary: dict):
    """The full-width olmoe-1b-7b contiguous engine, ``OL_ENGINE_LAYERS``
    deep (module docstring, phase 7). Returns each counted wrapper's
    launches in the captured run and the engine's weights."""
    args = serve_cli.build_parser().parse_args(OLMOE_ARGS)
    engine, _, _ = serve_cli.build(args, cfg=olmoe_engine_cfg())
    res = serve_modes(engine, args, "olmoe-1b-7b contiguous")
    out, stats, counts = (res["captured"][k]
                          for k in ("out", "stats", "launches"))
    cfg = engine.cfg
    _check_outputs("olmoe", engine, out, args.max_new)
    launches = {"flash_attention": counts["flash_attention"],
                "grouped_matmul": counts["grouped_matmul"]}
    plain_calls = sum(v for k, v in counts.items() if k.endswith("_plain"))
    finite = all(bool(torch.isfinite(b).all())
                 for b in engine.pool.buffers.values())
    # every decode step reads every layer's weights (the expert einsum runs
    # all 64 experts) and the unembedding: its least time on the card
    step_bytes = (sum(_nbytes(lp) for lp in engine.params["layers"])
                  + _nbytes(engine.params["emb"]["lm_head"]))
    expert_bytes = sum(_nbytes(lp[n]) for lp in engine.params["layers"]
                       for n in ("we_gate_up", "we_down"))
    print(json.dumps({"olmoe_engine": {k: getattr(stats, k) for k in (
        "n_requests", "new_tokens", "decode_rows_saved", "max_active",
        "mean_latency_s")}, "launches": launches,
        "plain_calls": plain_calls, "kv_finite": finite,
        "decode_step_bytes_gb": step_bytes / 1e9,
        "expert_bytes_gb": expert_bytes / 1e9,
        "decode_step_floor_ms": 1e3 * step_bytes / HBM_BPS,
        "sample_output": out[0].output[:8]}), flush=True)
    if not finite:
        raise SystemExit("FAIL: non-finite values in the contiguous cache")
    want = cfg.n_layers * stats.prefill_dispatches
    if (stats.prefill_dispatches != args.batch
            or launches["flash_attention"] != want or plain_calls):
        raise SystemExit(
            f"FAIL: flash launches {launches['flash_attention']} (want "
            f"{want} = {cfg.n_layers} layers x {stats.prefill_dispatches} "
            f"prefills), plain calls {plain_calls}: the olmoe prefill did "
            "not run the flash kernel")
    if "contiguous" not in _kinds(engine):
        raise SystemExit(f"FAIL: olmoe graphs {engine.graphs.keys}")
    summary["olmoe-1b-7b contiguous"] = _summary(res)
    summary["olmoe-1b-7b contiguous"]["busy_share"] = profile_engine(
        engine, args, res, "flash_")
    return launches, engine.params


def run_paged_engine(summary: dict, args, what: str, params,
                     modes=("replayed",), make=None, cfg=None) -> tuple:
    """A full-width paged engine of ``args`` (running ``cfg`` when given)
    on ``params`` (weights drawn from the seed when None; phases 5, 8, 9
    and 13b), serving ``args``' requests (``make()``'s when given): its
    three runs (``serve_modes``), its checks (outputs, finite pools, a
    shared prefix hit, both paged kernels launched and no plain version,
    no flash, decode horizons and prefill rounds as graphs) and profiled
    runs of ``modes``. Returns (the engine, its three runs' results, each paged
    kernel's launches in the captured run)."""
    engine, _, _ = serve_cli.build(args, params=params, cfg=cfg)
    res = serve_modes(engine, args, what, make)
    out, stats, counts = (res["captured"][k]
                          for k in ("out", "stats", "launches"))
    _check_outputs(what, engine, out, args.max_new)
    launches = {"paged_decode": counts["paged_attention"],
                "paged_prefill": counts["paged_prefill_attention"]}
    plain_calls = sum(v for k, v in counts.items() if k.endswith("_plain"))
    finite = bool(torch.isfinite(engine.pool.buffers.k_buf).all()
                  and torch.isfinite(engine.pool.buffers.v_buf).all())
    # a decode step reads every weight but the (untied) embedding table
    emb = engine.params["emb"]
    step_bytes = (_nbytes(engine.params)
                  - ("lm_head" in emb) * _nbytes(emb["tok_emb"]))
    print(json.dumps({"paged_engine": {"what": what, **{
        k: getattr(stats, k) for k in (
            "n_requests", "new_tokens", "preemptions", "prefix_hit_rate",
            "decode_rows_saved", "max_active", "mean_latency_s")}},
        "prompt_tokens": sum(len(r.prompt) for r in out),
        "launches": launches, "plain_calls": plain_calls,
        "flash_launches": counts["flash_attention"],
        "audit": engine.pool.audit(), "kv_finite": finite,
        "decode_step_bytes_gb": step_bytes / 1e9,
        "decode_step_floor_ms": 1e3 * step_bytes / HBM_BPS,
        "sample_output": out[0].output[:8]}), flush=True)
    if not finite:
        raise SystemExit(f"FAIL: {what}: non-finite values in the KV pools")
    if args.shared_prefix and stats.prefix_hit_rate <= 0:
        raise SystemExit(f"FAIL: {what}: the shared prefix never hit")
    if (min(launches.values()) <= 0 or plain_calls
            or counts["flash_attention"]):
        raise SystemExit(f"FAIL: {what}: launches {launches}, plain calls "
                         f"{plain_calls}, flash {counts['flash_attention']}: "
                         "the engine did not run the paged kernels alone")
    if not {"paged", "prefill"} <= _kinds(engine):
        raise SystemExit(f"FAIL: {what} graphs {engine.graphs.keys}")
    summary[what] = _summary(res)
    phase("profile")
    summary[what]["busy_share"] = profile_engine(engine, args, res, "paged_",
                                                 modes, make)
    return engine, res, launches


def run_olmoe_paged(summary: dict, params) -> dict:
    """The full-width olmoe-1b-7b paged engine on the contiguous engine's
    weights (module docstring, phase 8). Returns each paged kernel's
    launches in the captured run."""
    args = serve_cli.build_parser().parse_args(OLMOE_PAGED_ARGS)
    what = "olmoe-1b-7b paged"
    engine, res, launches = run_paged_engine(summary, args, what, params,
                                             cfg=olmoe_engine_cfg())
    out = res["captured"]["out"]
    summary[what]["prefix_cache"] = prefix_resume(
        params, out, res["captured"]["stats"])
    summary[what]["vs_contiguous"] = first_step_gap(engine, out)
    return launches


def _run_args(argv, params, cfg=None):
    """Serve ``argv``'s request set once on a new engine over ``params``
    (running ``cfg`` when given)."""
    args = serve_cli.build_parser().parse_args(argv)
    engine, _, _ = serve_cli.build(args, params=params, cfg=cfg)
    return engine.run(serve_cli.requests(args))


def prefix_resume(params, out, stats) -> dict:
    """Prefix-cache hits that resume the expert counts against cold runs.
    Exact (gated): one slot and one prefill lane, 16 new tokens, with and
    without the prefix cache — every chunk, round and decode step has the
    same shapes in both runs, so a block-aligned hit that resumes the
    counts gives the cold run's tokens bit for bit. Reported: the phase's
    own run (``out``, ``stats``: 4 slots, 4 lanes) against the same
    options without
    the prefix cache, whose schedule differs (deferrals behind a donor,
    other lane and decode widths) and so its f32 GEMMs' shapes: tokens may
    part where two logits nearly tie (the request and the first token
    that differs)."""
    cfg = olmoe_engine_cfg()
    cold, cold_stats = _run_args(OLMOE_PAGED_ARGS + ["--no-prefix-cache"],
                                 params, cfg)
    parted = {r.job_id: next(i for i, (a, b) in enumerate(
                  zip(r.output, c.output)) if a != b)
              for r, c in zip(out, cold) if r.output != c.output}
    one = OLMOE_PAGED_ARGS + ["--slots", "1", "--prefill-lanes", "1",
                              "--max-new", "16"]
    warm, warm_stats = _run_args(one, params, cfg)
    exact, exact_stats = _run_args(one + ["--no-prefix-cache"], params, cfg)
    same = sum(a.output == b.output for a, b in zip(warm, exact))
    rec = {"four_slots": {"identical_requests": len(out) - len(parted),
                          "requests": len(out),
                          "first_differing_token": parted,
                          "prefill_dispatches": [
                              stats.prefill_dispatches,
                              cold_stats.prefill_dispatches]},
           "one_slot": {"identical_requests": same, "requests": len(warm),
                        "prefix_hit_rate": warm_stats.prefix_hit_rate,
                        "prefill_dispatches": [
                            warm_stats.prefill_dispatches,
                            exact_stats.prefill_dispatches]}}
    print(json.dumps({"olmoe_paged_prefix_cache_on_vs_off": rec}),
          flush=True)
    if (same != len(warm) or warm_stats.prefix_blocks_hit <= 0
            or exact_stats.prefix_blocks_hit or cold_stats.prefix_blocks_hit):
        raise SystemExit(f"FAIL: olmoe paged, one slot: with the prefix "
                         f"cache {same} of {len(warm)} requests give the "
                         "cold run's tokens")
    return rec


def first_step_gap(engine, out) -> dict:
    """The paged engine's first tokens (``out``) against a one-pass MoE
    forward over each prompt (flash attention: the contiguous engine's
    prefill), and the largest gap between that forward's last logits and
    the block-chunked paged prefill's over the same prompt (one lane,
    counts carried, the engine's static capacity). Reported, not gated:
    the kernels differ."""
    cfg, params, model = engine.cfg, engine.params, engine.model
    bs, agree, gap = engine.block_size, 0, 0.0
    with torch.inference_mode():
        for r in out:
            n = len(r.prompt)
            prompt = torch.as_tensor(r.prompt, dtype=torch.int32,
                                     device="cuda")
            one_pass = moe.forward(cfg, params, prompt[None])[0, -1]
            nblk = -(-n // bs)
            cache = model.init_paged_cache(nblk, bs, device="cuda")
            tables = torch.arange(nblk, dtype=torch.int32,
                                  device="cuda")[None]
            state = model.paged_prefill_state(1, "cuda")
            caps = torch.tensor([moe.capacity(cfg, n)], dtype=torch.int32,
                                device="cuda")
            for s0 in range(0, n, bs):
                k = min(bs, n - s0)
                tok = torch.zeros((1, bs), dtype=torch.int32, device="cuda")
                tok[0, :k] = prompt[s0:s0 + k]
                logits, cache, state = model.paged_prefill_chunk(
                    params, cache, tok,
                    torch.tensor([s0], dtype=torch.int32, device="cuda"),
                    tables, state, engine.max_len,
                    n_valid=torch.tensor([k], dtype=torch.int32,
                                         device="cuda"),
                    cap_rows=caps)
            gap = max(gap, (logits[0, -1] - one_pass).abs().max().item())
            agree += int(one_pass.argmax()) == r.output[0]
    rec = {"first_token_agreement": agree, "requests": len(out),
           "max_first_step_logit_gap": gap}
    print(json.dumps({"olmoe_paged_vs_contiguous": rec}), flush=True)
    return rec


def run_phi3(summary: dict) -> tuple:
    """Full-width phi-3-vision-4.2b (module docstring, phase 9): forward and
    loss on [1, 1024] tokens with [1, 576, 3072] patch embeddings (flash in
    all 32 layers) against the same forward with the flash kernel's plain
    version in its place, then the paged engine on the same weights.
    Returns ({"forward": flash launches, "paged": paged launches}, the
    model, its weights): the synergy phase runs on them."""
    cfg = get_config("phi-3-vision-4.2b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, PHI_S), generator=g,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks,
             "labels": torch.randint(0, cfg.vocab_size, (1, PHI_S),
                                     generator=g, device="cuda",
                                     dtype=torch.int32),
             "patch_embeds": 0.02 * torch.randn(1, PHI_P, cfg.d_model,
                                                generator=g, device="cuda")}
    rec = {"params": sum(t.numel() for t in _leaves(params)),
           "tokens": PHI_S, "patches": PHI_P}
    with torch.inference_mode():
        model.forward(params, {k: v[:, :PHI_P + 64] if k == "tokens" else v
                               for k, v in batch.items()})      # warm-up
        ops.flash_attention.launches = fa.flash_attention_plain.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.forward(params, batch)
        torch.cuda.synchronize()
        rec["forward_ms"] = 1e3 * (time.perf_counter() - t0)
        launches = ops.flash_attention.launches
        if launches != cfg.n_layers or fa.flash_attention_plain.calls:
            raise SystemExit(f"FAIL: phi-3-vision forward: flash launches "
                             f"{launches} (want {cfg.n_layers}), plain "
                             f"calls {fa.flash_attention_plain.calls}")
        with plain_flash():
            ref = model.forward(params, batch)
        gap = (logits - ref).abs().max().item()
        rec.update(logits_shape=list(logits.shape),
                   plain_path_max_abs_diff=gap, finite=bool(torch.isfinite(logits).all()),
                   loss=model.loss(params, batch).item())
        print(json.dumps({"phi3_forward": rec}), flush=True)
        if (not rec["finite"] or tuple(logits.shape)
                != (1, PHI_S, cfg.vocab_size)):
            raise SystemExit("FAIL: phi-3-vision forward logits")
        if not torch.allclose(logits, ref, atol=1e-3, rtol=1e-3):
            raise SystemExit(f"FAIL: phi-3-vision forward differs from its "
                             f"plain path by {gap:.3e} (tol 1e-3)")
        del logits, ref
    args = serve_cli.build_parser().parse_args(PHI3_ARGS)
    _, _, paged = run_paged_engine(summary, args, "phi-3-vision-4.2b paged",
                                   params)
    return {"forward": launches, "paged": paged}, model, params


@contextlib.contextmanager
def plain_flash():
    """The model's flash calls take the kernel's plain version (on the
    card) while the context is open: the reference the forward is held to."""
    real = layers.kops.flash_attention

    def plain(q, k, v, *, causal=True, window=0):
        return fa.flash_attention_plain(q, k, v, causal, window)

    layers.kops.flash_attention = plain
    try:
        yield
    finally:
        layers.kops.flash_attention = real


def synergy_batch(cfg, batch: dict, step: int) -> dict:
    """A pipeline batch with the VLM's stub patch embeddings (the reference
    runtime's ``_adapt_batch``: a numpy generator seeded by the step, on
    the host), copied to the card from pinned memory without waiting."""
    rng = np.random.default_rng(step)
    patches = rng.standard_normal((batch["tokens"].shape[0], cfg.n_patches,
                                   cfg.d_model)).astype(np.float32) * 0.02
    host = dict(batch, patch_embeds=torch.from_numpy(patches))
    return {k: v.pin_memory().to("cuda", non_blocking=True)
            for k, v in host.items()}


def device_ms(fn) -> float:
    """``fn``'s device time on CUDA events (one call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _fail(what: str) -> None:
    raise SystemExit(f"FAIL: synergy: {what}")


def _iterator(dcfg, cpus: float, mem_gb: float):
    """A Synergy iterator over a new pipeline leased (cpus, mem_gb), with
    its channel and the list ``on_terminate`` appends to."""
    pipe = DataPipeline(dcfg, SYN_B, n_workers=max(1, int(round(cpus))))
    pipe.set_cache_gb(mem_gb)
    ch, ended = ControlChannel(0), []
    it = SynergyIterator(0, pipe, ch, on_terminate=lambda: ended.append(1))
    return pipe, ch, it, ended


def _end_lease(pipe, ch, it, gen, ended, n: int) -> None:
    """Terminate the lease after ``n`` batches: the iteration must stop,
    ``on_terminate`` run once and one progress message arrive a batch."""
    ch.terminate()
    rest = list(gen)
    progress = [p.iters for p in ch.drain_progress()]
    pipe.close()
    if rest or ended != [1] or not it.terminated:
        _fail(f"termination: {len(rest)} batches after it, on_terminate "
              f"ran {len(ended)} times, terminated {it.terminated}")
    if progress != list(range(1, n + 1)):
        _fail(f"progress {progress} after {n} batches")


def run_synergy() -> dict:
    """Phase ``synergy`` (module docstring): the optimistic profiler live on
    the card against phi-3-vision-4.2b's full-width train step at
    ``SYN_LAYERS`` layers (one Trainer, remat "full", f32 weights,
    gradients and AdamW moments), a lease update and a
    termination, then the simulator.
    Returns the flash forward and backward launches."""
    cfg = get_config("phi-3-vision-4.2b").replace(remat="full",
                                                  n_layers=SYN_LAYERS)
    trainer = Trainer(cfg, TrainerConfig(warmup_steps=2),
                      rng=torch.Generator(device="cuda").manual_seed(0))
    cls = MODEL_ZOO[ARCH_SENSITIVITY[cfg.arch_id]]
    spec, pcfg = ServerSpec(), ProfilerConfig()
    calls = [0]

    def step(batch):
        # the train step at full width (the reference runtime's
        # _measure_rate): forward, recompute and backward through the flash
        # kernels, AdamW; reading the loss syncs, as there
        calls[0] += 1
        return trainer.train_step(batch)

    with torch.enable_grad():
        # the device step the preprocessing cost is set from
        warm = DataPipeline(DataConfig(n_samples=SYN_B, seq_len=PHI_S,
                                       vocab_size=cfg.vocab_size), SYN_B)
        batch = synergy_batch(cfg, next(warm.batches(1)), 0)
        warm.close()
        step(batch)
        step_s = device_ms(lambda: step(batch)) / 1e3
        del batch
        # one worker takes cpus_to_saturate device steps a batch (9 for
        # resnet18's class): the curve's knee sits where the class's does
        cost = cls.cpus_to_saturate() * step_s / SYN_B
        n_samples = int(cls.dataset_gb * 1024 / cls.sample_mb)
        dcfg = DataConfig(n_samples=n_samples, seq_len=PHI_S,
                          vocab_size=cfg.vocab_size, preprocess_cost_s=cost,
                          sample_bytes=int(cls.sample_mb * (1 << 20)),
                          simulate_io=False, parallel_mode="scaled", seed=0)
        full_gb = n_samples * dcfg.sample_bytes / (1 << 30) + 1.0
        print(json.dumps({"synergy_job": {
            "arch": cfg.arch_id, "class": cls.name, "batch": SYN_B,
            "seq_len": PHI_S, "device_step_ms": 1e3 * step_s,
            "preprocess_cost_s_per_sample": cost, "n_samples": n_samples,
            "full_cache_gb": full_gb}}), flush=True)
        probes = []

        def measure(cpus: float) -> float:
            """Samples/s at ``cpus`` workers and a cache holding the whole
            dataset (the reference runtime's ``_measure_rate``): a warm-up
            step, then SYN_PROBE_ITERS steps timed on the device's clock from
            the warm-up's end. The host prepares each batch while the card
            runs the step before it."""
            t0 = time.perf_counter()
            flash0, bwd0, plain0, calls0 = (
                ops.flash_attention.launches,
                ops.flash_attention_backward.launches,
                fa.flash_attention_plain.calls, calls[0])
            pipe, ch, it, ended = _iterator(dcfg, cpus, full_gb)
            gen = iter(it)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            step(synergy_batch(cfg, next(gen), 0))
            start.record()
            # host seconds a timed batch: the pipeline (fetch and
            # preprocessing), the patch embeddings and copy, the enqueue
            host = np.zeros(3)
            for i in range(SYN_PROBE_ITERS):
                t = [time.perf_counter()]
                raw = next(gen)
                t.append(time.perf_counter())
                batch = synergy_batch(cfg, raw, i + 1)
                t.append(time.perf_counter())
                loss = step(batch)
                t.append(time.perf_counter())
                host += np.diff(t)
            end.record()
            _end_lease(pipe, ch, it, gen, ended, SYN_PROBE_ITERS + 1)
            end.synchronize()
            ms = start.elapsed_time(end)
            rec = {"cpus": cpus, "workers": pipe.n_workers,
                   "samples_per_s": SYN_PROBE_ITERS * SYN_B / (ms / 1e3),
                   "window_ms": ms, "wall_s": time.perf_counter() - t0,
                   "host_ms_a_batch": dict(zip(
                       ("pipeline", "patches_copy", "enqueue"),
                       (1e3 * host / SYN_PROBE_ITERS).tolist())),
                   "preprocess_ms_a_batch_set": 1e3 * cost * SYN_B
                   / pipe.n_workers,
                   "loss": loss["loss"], "grad_norm": loss["grad_norm"],
                   "flash_launches": ops.flash_attention.launches - flash0,
                   "flash_backward_launches":
                       ops.flash_attention_backward.launches - bwd0,
                   "plain_calls": fa.flash_attention_plain.calls - plain0,
                   "train_steps": calls[0] - calls0}
            print(json.dumps({"synergy_probe": rec}), flush=True)
            n = cfg.n_layers * rec["train_steps"]
            if (rec["flash_launches"] != 2 * n
                    or rec["flash_backward_launches"] != n
                    or rec["plain_calls"]):
                _fail(f"probe at {cpus} CPUs: flash launches "
                      f"{rec['flash_launches']} forward and "
                      f"{rec['flash_backward_launches']} backward for "
                      f"{rec['train_steps']} train steps, plain calls "
                      f"{rec['plain_calls']}")
            if not (math.isfinite(rec["samples_per_s"])
                    and rec["samples_per_s"] > 0
                    and math.isfinite(rec["loss"])
                    and math.isfinite(rec["grad_norm"])):
                _fail(f"probe at {cpus} CPUs: {rec}")
            probes.append(rec)
            return rec["samples_per_s"]

        wm = WorkloadModel(name=cfg.arch_id, task=cls.task,
                           batch_per_gpu=SYN_B, t_gpu=1.0, k_cpu=0.0,
                           sample_mb=cls.sample_mb,
                           dataset_gb=cls.dataset_gb,
                           disk_bw_mbps=dcfg.disk_bw_bytes / 1e6)
        profiler = OptimisticProfiler(spec, pcfg)
        ops.set_counts([0] * len(ops.COUNTERS))
        calls[0], step0 = 0, trainer.step
        t0 = time.perf_counter()
        mat = profiler.profile(wm, 1, measure_fn=measure)
        profile_s = time.perf_counter() - t0
        job = Job(0, cls.name, 1, 0.0, 3600.0, arch_id=cfg.arch_id)
        job.matrix = mat
        cg, mg = Cluster(1, spec).proportional_demand(1)
        job.prop_rate = mat.rate(cg, mg)
        job.demand_cpu, job.demand_mem = mat.best_demand(
            floor_rate=job.prop_rate)

        # the scheduler's lease at the knee, retuned mid-stream to the
        # GPU-proportional share, then terminated
        pipe, ch, it, ended = _iterator(dcfg, job.demand_cpu, job.demand_mem)
        gen = iter(it)
        step(synergy_batch(cfg, next(gen), 0))
        ch.send_lease(cg, mg)
        loss = step(synergy_batch(cfg, next(gen), 1))
        lease = (pipe.n_workers, pipe.cache.capacity_bytes)
        _end_lease(pipe, ch, it, gen, ended, 2)
        lease_loss = loss["loss"]
    launches = ops.flash_attention.launches
    bwd = ops.flash_attention_backward.launches
    plain = fa.flash_attention_plain.calls
    rec_step = trainer.step - step0
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    bound = math.ceil(math.log2(len(profiler.cpu_grid(1)))) + 2
    rec = {"probed": [[p["cpus"], p["samples_per_s"]] for p in probes],
           "probes": mat.profile_probes, "max_probes": bound,
           "W_shape": list(mat.W.shape),
           "knee_demand": [job.demand_cpu, job.demand_mem],
           "knee_rate": mat.rate(job.demand_cpu, job.demand_mem),
           "proportional_share": [cg, mg], "proportional_rate": job.prop_rate,
           "max_rate": mat.max_rate(),
           "probe_wall_s": [p["wall_s"] for p in probes],
           "profile_wall_s": profile_s,
           "profile_seconds_accounted": mat.profile_seconds,
           "lease": {"sent": [cg, mg], "workers": lease[0],
                     "cache_bytes": lease[1], "loss": lease_loss},
           "flash_launches": launches, "flash_backward_launches": bwd,
           "train_steps": calls[0], "trainer_steps": rec_step,
           "plain_calls": plain}
    print(json.dumps({"synergy_profile": rec}), flush=True)
    if mat.profile_probes != len(probes) or len(probes) > bound:
        _fail(f"{len(probes)} probes (at most {bound})")
    if mat.W.shape != (len(profiler.cpu_grid(1)),
                       len(profiler.mem_grid(1))) or mat.W.shape[0] != 24:
        _fail(f"W has shape {mat.W.shape}")
    if not (np.isfinite(mat.W).all() and rec["knee_rate"] >= job.prop_rate):
        _fail(f"the knee {rec['knee_demand']} runs at {rec['knee_rate']}, "
              f"below the proportional {job.prop_rate}")
    if lease != (round(cg), int(mg * (1 << 30))) or not math.isfinite(
            lease_loss):
        _fail(f"the lease ({cg}, {mg}) shows as {lease}")
    if (launches != 2 * cfg.n_layers * calls[0]
            or bwd != cfg.n_layers * calls[0] or plain
            or rec_step != calls[0]):
        _fail(f"flash launched {launches} times forward and {bwd} backward "
              f"for {calls[0]} train steps (the trainer took {rec_step}), "
              f"plain calls {plain}")
    run_simulator()
    return {"flash_attention": launches, "flash_attention_backward": bwd}


#: phase ``train-bf16``: phi-3-vision-4.2b at full width and depth in bf16
#: (the dry-run's train overrides), remat "full", AdamW at TB16_LR after a
#: one-step warm-up, on SYN_B x PHI_S tokens with PHI_P patch embeddings: a
#: warm step and TB16_STEPS timed ones on the same batch; one step against
#: the same step in f32 (loss within TB16_LOSS_TOL relative, every leaf's
#: gradient cosine at least TB16_MIN_COS)
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
TB16_STEPS, TB16_LR = 4, 3e-4
TB16_LOSS_TOL, TB16_MIN_COS = 1e-2, 0.99


def tb16_batch(cfg) -> dict:
    """[SYN_B, PHI_S] tokens and labels and [SYN_B, PHI_P, d_model] patch
    embeddings on the card, the embeddings bf16 values held in f32 so the
    bf16 and f32 steps read the same numbers."""
    g = torch.Generator(device="cuda").manual_seed(11)
    tok = (SYN_B, PHI_S)
    return {"tokens": torch.randint(0, cfg.vocab_size, tok, generator=g,
                                    device="cuda", dtype=torch.int32),
            "labels": torch.randint(0, cfg.vocab_size, tok, generator=g,
                                    device="cuda", dtype=torch.int32),
            "patch_embeds": (0.02 * torch.randn(
                SYN_B, PHI_P, cfg.d_model, generator=g, device="cuda"))
            .bfloat16().float()}


def _flash_counts() -> tuple:
    return (ops.flash_attention.launches,
            ops.flash_attention_backward.launches,
            fa.flash_attention_plain.calls)


def _loss_grads(model, params, batch) -> tuple:
    """(loss, gradients a leaf, device ms, flash (forward, backward, plain)
    counts) of one forward and backward; the params' grads cleared."""
    before = _flash_counts()
    with torch.enable_grad():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = model.loss(params, batch)
        loss.backward()
        end.record()
    end.synchronize()
    grads = [p.grad for p in optimizer.leaves(params)]
    for p in optimizer.leaves(params):
        p.grad = None
    counts = tuple(a - b for a, b in zip(_flash_counts(), before))
    return loss.item(), grads, start.elapsed_time(end), counts


def bf16_vs_f32(cfg, batch) -> dict:
    """One bf16 step's loss and gradients against the same step in f32 on
    the same values (the f32 weights the bf16 ones upcast), both through
    the flash kernels: the loss gap, each leaf's gradient cosine."""
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    for p in optimizer.leaves(params):
        p.requires_grad_(True)
    loss16, g16, ms16, n16 = _loss_grads(model, params, batch)
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    p32 = optimizer.tree_map(
        lambda p: p.detach().float().requires_grad_(True), params)
    del params
    loss32, g32, ms32, n32 = _loss_grads(build_model(cfg32), p32, batch)
    del p32
    cos = []
    for a, b in zip(g16, g32):
        a = a.float()
        den = (a.norm() * b.norm()).item()
        cos.append(1.0 if den == 0 else (a * b).sum().item() / den)
    worst = min(range(len(cos)), key=cos.__getitem__)
    del g16, g32
    gap = abs(loss16 - loss32) / abs(loss32)
    rec = {"layers": cfg.n_layers, "loss_bf16": loss16, "loss_f32": loss32,
           "loss_gap_rel": gap, "min_grad_cosine": cos[worst],
           "min_cosine_leaf": worst, "leaves": len(cos),
           "fwd_bwd_ms": {"bfloat16": ms16, "float32": ms32},
           "flash_launches": {"bfloat16": list(n16), "float32": list(n32)}}
    print(json.dumps({"train_bf16_vs_f32": rec}), flush=True)
    n = cfg.n_layers
    for counts in (n16, n32):
        if counts != (2 * n, n, 0):
            raise SystemExit(f"FAIL: train-bf16: one step launched flash "
                             f"(forward, backward, plain) {counts}, want "
                             f"({2 * n}, {n}, 0)")
    if not (math.isfinite(loss16) and gap <= TB16_LOSS_TOL
            and cos[worst] >= TB16_MIN_COS):
        raise SystemExit(f"FAIL: train-bf16: the bf16 step differs from the "
                         f"f32 step: {rec}")
    return rec


def run_train_bf16() -> dict:
    """Phase ``train-bf16`` (module docstring): phi-3-vision-4.2b trained in
    bf16 at full width through the flash forward (with its log-sum-exp)
    and the bf16 backward kernel. Returns the launches of the Trainer's
    steps."""
    t0 = time.perf_counter()
    cfg = get_config("phi-3-vision-4.2b").replace(remat="full", **BF16)
    batch = tb16_batch(cfg)
    rec = {"arch": cfg.arch_id, "remat": cfg.remat, "dtype": cfg.dtype,
           "batch": SYN_B, "seq": PHI_S, "patches": PHI_P,
           "vs_f32": bf16_vs_f32(cfg, batch)}
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(cfg, TrainerConfig(peak_lr=TB16_LR, warmup_steps=1,
                                         total_steps=100),
                      rng=torch.Generator(device="cuda").manual_seed(0))
    leaves = list(optimizer.leaves(trainer.state["params"]))
    rec["params"] = sum(p.numel() for p in leaves)
    rec["weights_gb"] = sum(p.numel() * p.element_size()
                            for p in leaves) / 1e9
    torch.cuda.reset_peak_memory_stats()
    ops.set_counts([0] * len(ops.COUNTERS))
    with torch.enable_grad():
        hist = [trainer.train_step(batch) for _ in range(1 + TB16_STEPS)]
    counts = dict(zip(COUNTER_NAMES, ops.counts()))
    steps = [h["step_seconds"] for h in hist[1:]]
    rec.update(steps=len(hist), losses=[h["loss"] for h in hist],
               grad_norms=[h["grad_norm"] for h in hist],
               ms_per_step=1e3 * statistics.mean(steps),
               ms_steps=[1e3 * x for x in steps],
               tokens_per_s=SYN_B * PHI_S / statistics.mean(steps),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches={k: counts[k] for k in (
                   "flash_attention", "flash_attention_backward",
                   "flash_attention_plain")},
               params_dtypes=sorted({str(p.dtype)[6:] for p in leaves}))
    del trainer, leaves, batch
    gc.collect()
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"train_bf16": rec}), flush=True)
    n = cfg.n_layers * len(hist)
    if (counts["flash_attention"] != 2 * n
            or counts["flash_attention_backward"] != n
            or counts["flash_attention_plain"]):
        raise SystemExit(f"FAIL: train-bf16: {rec['launches']} over "
                         f"{len(hist)} steps (want {2 * n} forward and "
                         f"recompute, {n} backward, 0 plain)")
    if rec["params_dtypes"] != ["bfloat16"] or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
            for h in hist) or hist[-1]["loss"] >= hist[0]["loss"]:
        raise SystemExit(f"FAIL: train-bf16: params {rec['params_dtypes']}, "
                         f"losses {rec['losses']}, grad norms "
                         f"{rec['grad_norms']}: not bf16, not finite or "
                         f"not falling")
    return counts


def _sim_record(res, wall_s: float) -> dict:
    done = [j for j in res.jobs if j.finish_time is not None]
    return {"avg_jct_h": res.avg_jct / 3600, "p99_jct_h": res.p99_jct / 3600,
            "makespan_h": res.makespan / 3600, "rounds": res.rounds,
            "finished": len(done), "jobs": len(res.jobs), "wall_s": wall_s}


def run_simulator() -> dict:
    """The port's simulator on the card's host: each allocator of
    SIM_ALLOCATORS on SIM_SERVERS servers and a Philly trace under SRTF,
    then Synergy-OPT on OPT_SERVERS servers; every job must finish, and
    TUNE keep within tests/test_scheduler.py's bounds of proportional."""
    res = {}
    for name in SIM_ALLOCATORS:
        t0 = time.perf_counter()
        r = simulate(SIM_SERVERS, philly_trace(**SIM_TRACE), policy="srtf",
                     allocator=name)
        res[name] = _sim_record(r, time.perf_counter() - t0)
    t0 = time.perf_counter()
    r = simulate(OPT_SERVERS, generate(TraceConfig(**OPT_TRACE)),
                 policy="srtf", allocator="opt")
    res["opt"] = dict(_sim_record(r, time.perf_counter() - t0),
                      servers=OPT_SERVERS, solve_s=r.opt_solve_seconds)
    print(json.dumps({"synergy_simulator": res}), flush=True)
    for name, rec in res.items():
        if rec["finished"] != rec["jobs"]:
            _fail(f"{name}: {rec['finished']} of {rec['jobs']} jobs finished")
    prop, tune = res["proportional"], res["tune"]
    if (tune["avg_jct_h"] > prop["avg_jct_h"] * 1.03
            or tune["makespan_h"] > prop["makespan_h"] * 1.05):
        _fail(f"tune {tune} against proportional {prop}")
    return res


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def _nbytes(tree) -> int:
    """The bytes of a tree's tensors, each at its own element size."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


#: profiled windows a run may take before incomplete ones fail it
#: (``profile_complete``)
PROFILE_ATTEMPTS = 4
#: each hand-written kernel's name fragment in a profile, and the launch
#: counter whose launches it is (the paged merge: see ``implied_events``)
KERNEL_EVENTS = {"flash_attention_kernel": "flash_attention",
                 "paged_decode_kernel": "paged_attention",
                 "paged_prefill_kernel": "paged_prefill_attention",
                 "grouped_matmul_kernel": "grouped_matmul",
                 "ssd_scan_chunk_kernel": "ssd_scan"}


def implied_events(engine, counts: dict) -> dict:
    """The device events of each hand-written kernel that the launch
    counters ``counts`` imply on ``engine``: one a launch, and one merge
    after each paged launch whose table walk is split (the split plan
    depends only on the pool's table width and block size)."""
    want = {frag: counts[name] for frag, name in KERNEL_EVENTS.items()}
    mb = getattr(engine.pool, "max_blocks", 0)

    def split(keys):
        return int(mb > 0 and pa.split_plan(mb, engine.block_size,
                                            keys)[1] > 1)

    want["paged_merge_kernel"] = (
        counts["paged_attention"] * split(pa.DECODE_SPLIT_KEYS)
        + counts["paged_prefill_attention"] * split(pa.SPLIT_KEYS))
    return want


def profile_engine(engine, args, res: dict, ours: str,
                   modes=("replayed", "eager"), make=None) -> dict:
    """torch.profiler over the engine phase's own request set (``args``,
    or ``make()``'s) on
    ``engine``, whose signatures ``serve_modes`` captured: a replayed and an
    eager run, each profiled alone with every launch counter set to 0 just
    before. A window counts only when the profiler saw, of each
    hand-written kernel, the launches that the counters say
    (``implied_events``; under replay the counters are the capture's
    launches added back per replay, so this is what shows that a replay ran
    the kernels); else the run is profiled again (``profile_complete``),
    and fails after four. Fails too if the replayed run captured anything. The profiler slows the host (it records every launch),
    so the busy share is given twice: the device's busy seconds over the
    profiled run's wall clock, and over the wall clock of the unprofiled run
    of the same mode in ``res`` (same requests, same kernels). Prints the
    device time by kernel (``ours``: the name fragment of this path's
    kernels); returns {mode: both shares}. ``modes``: the runs to profile.
    """
    print(f"profile {args.arch} {args.cache} ({time.strftime('%H:%M:%S')})",
          flush=True)
    make = make or (lambda: serve_cli.requests(args))
    share = {}
    for mode in modes:
        runs, keys = [], len(engine.graphs.keys)

        def serve():
            ops.set_counts((0,) * len(ops.COUNTERS))
            runs.append(engine.run(make()))

        def missing(rec):
            counts = dict(zip(COUNTER_NAMES, ops.counts()))
            want = implied_events(engine, counts)
            seen = {frag: sum(n for name, n in rec["events"].items()
                              if frag in name) for frag in want}
            rec["kernel_events"] = {k: v for k, v in seen.items() if v}
            if seen != want:
                return (f"kernel events {seen}, the launch counters imply "
                        f"{want}")
            return None

        with _mode(mode):
            rec = profile_complete(serve, ours, missing)
        del rec["events"]
        out, stats = runs[-1]
        share[mode] = {
            "profiled_wall": rec["device_busy_share"],
            "unprofiled_wall":
                rec["device_busy_s"] / res[mode]["stats"].wall_s}
        print(json.dumps({"profile": {
            "arch": args.arch, "cache": args.cache, "mode": mode,
            "requests": args.batch, "slots": args.slots,
            "prompt_tokens": sum(len(r.prompt) for r in out),
            "prefill_s": stats.prefill_s, "decode_s": stats.decode_s,
            "prefill_dispatches": stats.prefill_dispatches,
            "steps": stats.steps, "max_active": stats.max_active,
            "unprofiled_wall_s": res[mode]["stats"].wall_s,
            "busy_share_of_unprofiled_wall": share[mode]["unprofiled_wall"],
            **rec}}), flush=True)
        if len(engine.graphs.keys) != keys:
            raise SystemExit(f"FAIL: {args.arch} {mode}: the profiled run "
                             "captured new signatures")
    return share


def profile_complete(fn, ours: str, missing=lambda rec: None) -> dict:
    """``profile_call(fn, ours)`` until a window holds every event of its
    run: the marker seen and ``missing(rec)`` (what else the run's events
    must show) None. The profiler loses events now and then, at a window's
    end or inside it (``tools/profiler_probe.py``); an incomplete window is
    discarded, with a line saying why, and the run profiled again. Fails
    after ``PROFILE_ATTEMPTS`` incomplete windows in a row: a loss that
    repeats is the program's, not the profiler's."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        rec = profile_call(fn, ours)
        why = (missing(rec) if rec.pop("marker_seen")
               else "the marker kernel was lost")
        if why is None:
            rec["attempt"] = attempt
            return rec
        print(json.dumps({"profile_discarded": {
            "attempt": attempt, "device_events": rec["device_events"],
            "why": why}}), flush=True)
    raise SystemExit(f"FAIL: {PROFILE_ATTEMPTS} profiles in a row were "
                     f"incomplete: {why}")


def profile_call(fn, ours: str) -> dict:
    """torch.profiler over one call of ``fn``, device activity only: its
    wall clock, the device's busy seconds (the union of its kernel, copy
    and fill intervals) and share, the device time of the kernels whose
    names hold ``ours``, the top kernels by device time, and the number of
    events by name (``events``). The raw events are read directly: an
    eager engine run makes hundreds of thousands, and one Python object
    each (``key_averages``) made the profile phases most of the script's
    time. A marker kernel follows ``fn`` inside the window; ``marker_seen``
    says whether the profiler kept it, so whether it lost events at the
    window's end (the window stays open 0.1 s past the marker: closed at
    once, it dropped the marker more often). Fails if there was no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(1000)                 # the marker: spin_kernel
        torch.cuda.synchronize()
        time.sleep(0.1)   # the window must close after the marker's end
    spans, by_name, marker = [], {}, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name()
        if "spin_kernel" in name:
            marker += 1
            continue
        a, b = ev.start_ns(), ev.end_ns()
        spans.append((a, b))
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + (b - a) / 1e3, n + 1)
    busy_ns, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy_ns += b - a
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    busy_s = busy_ns / 1e9
    if busy_s <= 0:
        raise SystemExit("FAIL: the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    mine = sorted(((k, us, n) for k, (us, n) in by_name.items() if ours in k),
                  key=lambda x: -x[1])
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall, "device_events": len(spans),
            "marker_seen": marker > 0,
            f"{ours}kernels_s": sum(us for _, us, _ in mine) / 1e6,
            f"{ours}kernels": [{"name": k[:80], "s": us / 1e6, "count": n}
                               for k, us, n in mine],
            "top_kernels": [{"name": k[:80], "s": us / 1e6, "count": n}
                            for k, (us, n) in top],
            "events": {k: n for k, (_, n) in by_name.items()}}


def run_mamba2() -> int:
    """Full-width mamba2-780m forward and loss on [2, 4096] tokens, then the
    recurrent decode chain on a [1, 256] prefix against the forward's
    logits, then a profiled forward (module docstring, phase 8). Returns
    the SSD kernel's launches in one forward."""
    cfg = get_config("mamba2-780m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params["emb"])) + sum(
        t.numel() for lp in params["layers"] for t in _leaves(lp))
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (M2_B, M2_S), generator=g,
                         device="cuda", dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (M2_B, M2_S), generator=g,
                           device="cuda", dtype=torch.int32)
    rec = {"params": n_params, "tokens": M2_B * M2_S}
    with torch.inference_mode():
        model.forward(params, {"tokens": toks[:, :M2_Q]})       # warm-up
        launches = {}
        for name, fn in (("forward", lambda: model.forward(
                             params, {"tokens": toks})),
                         ("loss", lambda: model.loss(
                             params, {"tokens": toks, "labels": labels}))):
            ops.ssd_scan.launches = 0
            ssd.ssd_scan_plain.calls = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[name] = ops.ssd_scan.launches
            if launches[name] != cfg.n_layers or ssd.ssd_scan_plain.calls:
                raise SystemExit(
                    f"FAIL: mamba2 {name}: ssd_scan launches "
                    f"{launches[name]} (want {cfg.n_layers}), plain calls "
                    f"{ssd.ssd_scan_plain.calls}")
            if not bool(torch.isfinite(out).all()):
                raise SystemExit(f"FAIL: mamba2 {name} is not finite")
            rec[f"{name}_ms"] = 1e3 * wall
            rec[f"{name}_tokens_per_s"] = M2_B * M2_S / wall
            if name == "forward":
                if tuple(out.shape) != (M2_B, M2_S, cfg.vocab_size):
                    raise SystemExit(f"FAIL: logits {tuple(out.shape)}")
                prefix = out[0, :M2_Q].clone()
            else:
                rec["loss"] = out.item()
            del out
        # the recurrent path at the published widths against the kernel's
        cache = model.init_cache(1, M2_Q, device="cuda")
        gap = 0.0
        t0 = time.perf_counter()
        for t in range(M2_Q):
            logits, cache = model.decode_step(params, cache,
                                              toks[:1, t:t + 1], t)
            gap = max(gap, (logits[0, 0] - prefix[t]).abs().max().item())
            if not torch.allclose(logits[0, 0], prefix[t], atol=2e-3,
                                  rtol=1e-5):
                raise SystemExit(f"FAIL: mamba2 decode step {t} differs from "
                                 f"the forward by {gap:.3e} (tol 2e-3)")
        rec["decode_steps"] = M2_Q
        rec["decode_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / M2_Q
        rec["decode_vs_forward_max_abs_diff"] = gap
        rec["launches_per_forward"] = launches
        print(json.dumps({"mamba2_forward": rec}), flush=True)
        prof = profile_complete(
            lambda: model.forward(params, {"tokens": toks}), "ssd_scan_")
        del prof["events"]
        print(json.dumps({"profile": {"arch": cfg.arch_id,
                                      "call": "forward [2, 4096]", **prof}}),
              flush=True)
    return launches["forward"]


#: the train phase: mamba2-780m at full width (remat "full"), batches of
#: TRAIN_B sequences of TRAIN_S tokens, TRAIN_STEPS steps of AdamW at peak
#: lr TRAIN_LR after a 2-step warm-up; the one-step comparison with the
#: plain scan holds the loss and the gradient norm to TRAIN_TOL (relative)
#: and a sample of gradient entries to TRAIN_GRAD_TOL of the largest |g|
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 2, 4096, 8, 1e-3
TRAIN_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
TRAIN_DIR = os.path.join(ROOT, "build", "train")
#: the CLI run on the card and its resume
TRAIN_CLI = ["--arch", "mamba2-780m", "--preset", "25m", "--steps", "20",
             "--device", "cuda"]


def _grads_and_norm(trainer, batch, idx):
    """(loss, global grad norm, the gradient entries at ``idx``, one index
    tensor a leaf) of one forward and backward on ``batch`` without an
    optimizer step; the grads are cleared after."""
    params = trainer.state["params"]
    loss = trainer.model.loss(params, batch)
    loss.backward()
    grads = [p.grad for p in optimizer.leaves(params)]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads)).item()
    sample = torch.cat([g.flatten()[i] for g, i in zip(grads, idx)])
    for p in optimizer.leaves(params):
        p.grad = None
    return loss.item(), norm, sample


def run_train() -> dict:
    """Phase ``train`` (module docstring): launch/train.py's config of
    mamba2-780m at full width with remat "full" through Trainer.fit on a
    DataPipeline; one step against the plain scan; then the CLI and its
    resume. Returns the SSD forward and backward launches of the fit."""
    cfg = train_cli.build_cfg("mamba2-780m", "full").replace(remat="full")
    # a dataset of one batch, seen each step (rolled by a token an epoch, as
    # the pipeline augments): the loss has something to fall to
    pipe = DataPipeline(DataConfig(n_samples=TRAIN_B, seq_len=TRAIN_S,
                                   vocab_size=cfg.vocab_size),
                        TRAIN_B, n_workers=2)
    trainer = Trainer(cfg, TrainerConfig(
        peak_lr=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS),
        rng=torch.Generator(device="cuda").manual_seed(0))
    rec = {"arch": cfg.arch_id, "remat": cfg.remat, "batch": TRAIN_B,
           "seq": TRAIN_S,
           "params": sum(p.numel() for p in optimizer.leaves(
               trainer.state["params"]))}
    # one step's loss, grad norm and gradients against the plain scan
    first = {k: v.to("cuda") for k, v in next(pipe.batches(1)).items()}
    g = torch.Generator(device="cuda").manual_seed(2)
    idx = [torch.randint(0, p.numel(), (64,), generator=g, device="cuda")
           for p in optimizer.leaves(trainer.state["params"])]
    got = _grads_and_norm(trainer, first, idx)
    with plain_ssd():
        want = _grads_and_norm(trainer, first, idx)
    sample, ref = got[2], want[2]
    gap = (sample - ref).abs().max().item() / ref.abs().max().item()
    rec["plain_step"] = {"loss": [got[0], want[0]],
                         "grad_norm": [got[1], want[1]],
                         "sampled_grads": int(ref.numel()),
                         "sample_max_err_over_max": gap}
    print(json.dumps({"train_vs_plain": rec["plain_step"]}), flush=True)
    if not (abs(got[0] - want[0]) <= TRAIN_TOL * abs(want[0])
            and abs(got[1] - want[1]) <= TRAIN_TOL * abs(want[1])
            and gap <= TRAIN_GRAD_TOL):
        raise SystemExit(f"FAIL: train: the kernel step differs from the "
                         f"plain scan's: {rec['plain_step']}")
    del sample, ref, first, got, want
    gc.collect()
    torch.cuda.empty_cache()

    ops.set_counts([0] * len(ops.COUNTERS))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = trainer.fit(pipe.batches(TRAIN_STEPS))
    wall = time.perf_counter() - t0
    pipe.close()
    counts = dict(zip(COUNTER_NAMES, ops.counts()))
    steps = [h["step_seconds"] for h in hist[1:]]
    rec.update(steps=len(hist), wall_s=wall,
               losses=[h["loss"] for h in hist],
               grad_norms=[h["grad_norm"] for h in hist],
               ms_per_step=1e3 * statistics.mean(steps),
               tokens_per_s=TRAIN_B * TRAIN_S / statistics.mean(steps),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches={k: counts[k] for k in (
                   "ssd_scan", "ssd_scan_backward", "ssd_scan_plain")})
    print(json.dumps({"train": rec}), flush=True)
    n = cfg.n_layers * len(hist)
    if counts["ssd_scan"] != 2 * n or counts["ssd_scan_backward"] != n or \
            counts["ssd_scan_plain"]:
        raise SystemExit(f"FAIL: train: {rec['launches']} over {len(hist)} "
                         f"steps (want {2 * n} forward and recompute, {n} "
                         f"backward, 0 plain)")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist) or hist[-1]["loss"] >= hist[0]["loss"]:
        raise SystemExit(f"FAIL: train: losses {rec['losses']}, grad norms "
                         f"{rec['grad_norms']}: not finite or not falling")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    rec["cli"] = train_cli_resume()
    return counts


def train_cli_resume() -> dict:
    """``python -m repro_torch.launch.train`` on the card with a checkpoint,
    then again: the second run resumes at the saved step; the checkpoint
    it resumed from restores into a Trainer leaf for leaf."""
    os.makedirs(TRAIN_DIR, exist_ok=True)
    ck = os.path.join(TRAIN_DIR, "mamba2-25m.ckpt")
    if os.path.exists(ck):
        os.unlink(ck)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = []
    for i in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
             "--ckpt", ck], capture_output=True, text=True, cwd=ROOT,
            env=env, timeout=300)
        if proc.returncode != 0:
            raise SystemExit(f"FAIL: train CLI run {i}: rc "
                             f"{proc.returncode}\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-2000:]}")
        summary = json.loads(proc.stdout[proc.stdout.index("{"):])
        summary["restored_line"] = [ln for ln in proc.stdout.splitlines()
                                    if ln.startswith("restored")]
        summary["process_s"] = time.perf_counter() - t0
        runs.append(summary)
        if i == 0:
            tr = Trainer(train_cli.build_cfg("mamba2-780m", "25m"),
                         TrainerConfig(ckpt_path=ck))
            if not tr.maybe_restore() or tr.step != 20:
                raise SystemExit(f"FAIL: train CLI: the checkpoint restores "
                                 f"at step {tr.step}, not 20")
            with open(ck, "rb") as f:
                payload = msgpack.unpackb(f.read())
            saved = [np.frombuffer(d[b"data"], np.dtype(d[b"dtype"]))
                     .reshape(d[b"shape"]) for d in payload[b"leaves"]]
            mine = [np.asarray(x) for _, x in
                    checkpoint._flatten(state_to_jax(tr.state))]
            if len(saved) != len(mine) or not all(
                    np.array_equal(a, b) for a, b in zip(saved, mine)):
                raise SystemExit("FAIL: train CLI: the restored state differs "
                                 "from the saved leaves")
            del tr
    if runs[1]["restored_line"] != ["restored checkpoint at step 20"]:
        raise SystemExit(f"FAIL: train CLI resume: {runs[1]}")
    rec = {"runs": runs}
    print(json.dumps({"train_cli": rec}), flush=True)
    if not all(math.isfinite(r["loss_last"]) for r in runs):
        raise SystemExit("FAIL: train CLI: loss not finite")
    return rec


#: the runtime phase (the reference runtime's smoke-width jobs): one
#: server of 2 GPUs, 6 CPUs and 4 GB under SRTF and tune; three 1-GPU jobs
#: (arch, iterations); a first round of RT_FIRST_ROUND_S whose drain
#: terminates the running leases, then rounds of RT_ROUND_S to the end
RT_JOBS = (("qwen2-0.5b", 24), ("mamba2-780m", 32),
           ("phi-3-vision-4.2b", 40))
RT_FIRST_ROUND_S, RT_ROUND_S = 0.5, 2.0
RT_DIR = os.path.join(ROOT, "build", "runtime")


def run_runtime() -> dict:
    """Phase ``runtime`` (module docstring): the live Synergy runtime on the
    card. Returns every counter's count over the phase."""
    shutil.rmtree(RT_DIR, ignore_errors=True)
    ops.set_counts([0] * len(ops.COUNTERS))
    t0 = time.perf_counter()
    rt = LiveRuntime(n_servers=1, spec=ServerSpec(gpus=2, cpus=6.0, mem=4.0),
                     policy="srtf", allocator="tune",
                     round_seconds=RT_FIRST_ROUND_S, probe_iters=2,
                     ckpt_dir=RT_DIR, device="cuda")
    for i, (arch, iters) in enumerate(RT_JOBS):
        rt.submit(LiveJobSpec(i, arch, total_iters=iters, batch_size=8,
                              preprocess_cost_s=0.002, dataset_gb=0.1,
                              seq_len=32))
    profile_s = time.perf_counter() - t0
    t_start = time.time()
    first = rt.run(max_rounds=1)        # its drain ends the running leases
    rt.round_seconds = RT_ROUND_S
    rt.run(max_rounds=200)
    m = rt.metrics(t_start)
    counts = dict(zip(COUNTER_NAMES, ops.counts()))
    jobs = [{"arch": lj.spec.arch_id, "iters": lj.iters_done,
             "total_iters": lj.spec.total_iters, "saves": lj.saves,
             "restores": lj.restores,
             "preemptions": lj.sched_job.n_preemptions,
             "demand": [lj.sched_job.demand_cpu, lj.sched_job.demand_mem],
             "prop_rate": lj.sched_job.prop_rate,
             "last_loss": lj.trainer.history[-1]["loss"]}
            for lj in rt.jobs.values()]
    rec = {"profile_s": profile_s, "first_run": first, "metrics": m,
           "jobs": jobs, "rounds": len(rt.round_log),
           "launches": {k: v for k, v in counts.items() if v}}
    print(json.dumps({"runtime": rec}), flush=True)
    print(f"runtime: avg JCT {m['avg_jct']:.2f} s, p99 JCT "
          f"{m['p99_jct']:.2f} s, makespan {m['makespan']:.2f} s", flush=True)
    if m["finished"] != len(RT_JOBS) or any(
            j["iters"] != j["total_iters"] for j in jobs):
        raise SystemExit(f"FAIL: runtime: jobs unfinished: {jobs}")
    if not any(j["saves"] and j["restores"] == j["saves"] for j in jobs) \
            or any(j["restores"] != j["saves"] for j in jobs):
        raise SystemExit(f"FAIL: runtime: no terminated lease resumed at its "
                         f"saved step: {jobs}")
    # the counters are not atomic across the job threads: some, and none
    if not all(counts[k] > 0 for k in ("flash_attention", "ssd_scan",
                                       "flash_attention_backward",
                                       "ssd_scan_backward")) or \
            counts["flash_attention_plain"] or counts["ssd_scan_plain"]:
        raise SystemExit(f"FAIL: runtime: launches {rec['launches']}")
    if not all(math.isfinite(j["last_loss"]) for j in jobs):
        raise SystemExit(f"FAIL: runtime: a loss is not finite: {jobs}")
    return counts


def run_mamba2_engine(summary: dict) -> None:
    """The full-width mamba2-780m contiguous engine at ``M2_ENGINE_LAYERS``
    of its 48 layers (module docstring, phase 11); the SSD kernel must not
    launch."""
    cfg = get_config("mamba2-780m").replace(n_layers=M2_ENGINE_LAYERS)
    run_recurrent_engine(summary, MAMBA2_ARGS, "mamba2-780m contiguous",
                         "ssd_scan_", cfg=cfg)


def run_recurrent_engine(summary: dict, argv, what: str, ours: str,
                         params=None, modes=("replayed", "eager"),
                         cfg=None) -> None:
    """A full-width contiguous engine whose prefill replays one captured
    batch-1 decode step a prompt token (mamba2, zamba2, whisper), on
    ``params`` (weights drawn from the seed when None): its three runs
    (``serve_modes``), its checks (outputs, finite cache, one prefill a
    request, no hand-written kernel launched and no plain version called
    — serving reaches neither the SSD scan nor flash, as in the reference
    — decode horizons and the recurrent step as graphs) and profiled runs
    of ``modes`` (``ours``: the name fragment of the kernels its forward
    runs; ``cfg``, when given, the config the engine runs)."""
    args = serve_cli.build_parser().parse_args(argv)
    engine, _, _ = serve_cli.build(args, params=params, cfg=cfg)
    res = serve_modes(engine, args, what)
    out, stats, counts = (res["captured"][k]
                          for k in ("out", "stats", "launches"))
    _check_outputs(what, engine, out, args.max_new)
    finite = all(bool(torch.isfinite(b).all())
                 for b in engine.pool.buffers.values())
    print(json.dumps({"recurrent_engine": {"what": what, **{
        k: getattr(stats, k) for k in (
            "n_requests", "new_tokens", "decode_rows_saved", "max_active",
            "mean_latency_s")}},
        "prompt_tokens": sum(len(r.prompt) for r in out),
        "launches": counts, "state_finite": finite,
        "cache_gb_per_slot": sum(b.numel() * b.element_size() for b in
                                 engine.pool.buffers.values())
        / engine.pool.n_slots / 1e9,
        "sample_output": out[0].output[:8]}), flush=True)
    print(f"{what}: no kernel launched and no plain version called: serving "
          "prefills by stepping the decode, as the reference does",
          flush=True)
    if not finite:
        raise SystemExit(f"FAIL: {what}: non-finite values in the cache")
    if any(counts.values()) or stats.prefill_dispatches != args.batch:
        raise SystemExit(f"FAIL: {what} ran a kernel or a plain version "
                         f"({counts}) or missed a prefill")
    if not {"contiguous", "recurrent_step"} <= _kinds(engine):
        raise SystemExit(f"FAIL: {what} graphs {engine.graphs.keys}")
    summary[what] = _summary(res)
    summary[what]["bucket_gather_scatter_ms"] = bucket_copy_ms(engine.pool)
    summary[what]["busy_share"] = profile_engine(engine, args, res, ours,
                                                 modes)


def bucket_copy_ms(pool) -> dict:
    """Device ms of the copies a horizon over a bucket of W < n_slots rows
    adds (``engine._contiguous_horizon``): every cache leaf's rows gathered
    with ``index_select`` and scattered back with ``index_copy_`` (a full
    bucket skips both), for W = 1, 2; printed beside the bytes moved over
    HBM bandwidth."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    slot_bytes = sum(b.numel() * b.element_size()
                     for b in pool.buffers.values()) / pool.n_slots
    rec, dev = {}, next(iter(pool.buffers.values())).device
    for w in (1, 2):
        idx = torch.arange(w, device=dev)

        @torch.inference_mode()          # the pool's tensors are inference
        def copy():                      # tensors (made under the engine's)
            for name, buf in pool.buffers.items():
                ax = pool.batch_axes[name]
                buf.index_copy_(ax, idx, buf.index_select(ax, idx))

        rec[w] = time_ms(copy, flush, reps=10)
        print(f"bucket of {w} row(s): gather + scatter {rec[w]:.4f} ms, "
              f"{4 * w * slot_bytes / 1e9:.3f} GB moved, at HBM bandwidth "
              f"{1e3 * 4 * w * slot_bytes / HBM_BPS:.4f} ms", flush=True)
    return rec


@contextlib.contextmanager
def plain_ssd():
    """The model's SSD scans take the kernel's plain version (on the card)
    while the context is open, with ``ops.ssd_scan``'s casts and chunk
    rule."""
    real = mamba2.kops.ssd_scan

    def plain(xdt, a_log, B, C, chunk=128):
        q = chunk
        while xdt.shape[1] % q:
            q //= 2
        return ssd.ssd_scan_plain(*(t.float().contiguous()
                                    for t in (xdt, a_log, B, C)), chunk=q)

    mamba2.kops.ssd_scan = plain
    try:
        yield
    finally:
        mamba2.kops.ssd_scan = real


def forward_and_loss(model, params, batch, wrapper, plain, what: str) -> dict:
    """``Model.forward`` and ``Model.loss`` on ``batch``, each timed alone
    with ``wrapper``'s launch counter and ``plain``'s call counter set to
    0 just before: each must launch the kernel once a layer that runs it
    (``model.cfg.n_layers``) and never call the plain version. Returns the
    times, the launches, the loss and the logits."""
    cfg, rec = model.cfg, {}
    for name, fn in (("forward", model.forward), ("loss", model.loss)):
        wrapper.launches = plain.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(params, batch)
        torch.cuda.synchronize()
        rec[f"{name}_ms"] = 1e3 * (time.perf_counter() - t0)
        rec[f"{name}_launches"] = wrapper.launches
        if wrapper.launches != cfg.n_layers or plain.calls:
            raise SystemExit(f"FAIL: {what} {name}: {wrapper.__name__} "
                             f"launches {wrapper.launches} (want "
                             f"{cfg.n_layers}), plain calls {plain.calls}")
        if not bool(torch.isfinite(out).all()):
            raise SystemExit(f"FAIL: {what} {name} is not finite")
        if name == "loss":
            rec["loss"] = out.item()
        else:
            logits = out
    want = tuple(batch["tokens"].shape) + (cfg.vocab_size,)
    if tuple(logits.shape) != want:
        raise SystemExit(f"FAIL: {what} logits {tuple(logits.shape)}, want "
                         f"{want}")
    rec["logits"] = logits
    return rec


def chain_gaps(what: str, steps, kernel, plain_path) -> dict:
    """The decode chain's logits [T, V] against the forward's at the same
    positions, with the kernel (held to ``CHAIN_TOL``) and with its plain
    version on the card (printed beside it: the depth's share of the gap
    and the kernel's are told apart)."""
    rec = {"decode_steps": steps.shape[0],
           "chain_vs_kernel_forward": (steps - kernel).abs().max().item(),
           "chain_vs_plain_forward": (steps - plain_path).abs().max().item(),
           "kernel_vs_plain_forward":
               (kernel - plain_path).abs().max().item(),
           "max_abs_logit": kernel.abs().max().item()}
    print(f"{what}: {steps.shape[0]} decode steps vs the forward with the "
          f"kernel {rec['chain_vs_kernel_forward']:.3e}, with its plain "
          f"version {rec['chain_vs_plain_forward']:.3e} (tol {CHAIN_TOL}); "
          f"kernel vs plain forward {rec['kernel_vs_plain_forward']:.3e}",
          flush=True)
    if not torch.allclose(steps, kernel, atol=CHAIN_TOL, rtol=1e-5):
        raise SystemExit(f"FAIL: {what}: the decode chain differs from the "
                         f"forward by {rec['chain_vs_kernel_forward']:.3e}")
    return rec


def run_zamba2(summary: dict) -> int:
    """Full-width zamba2-7b (module docstring, phase 12): forward and loss
    on [1, 4096] tokens (81 SSD launches each), the forward again with the
    scan's plain version, a 128-step decode chain against both, then its
    contiguous engine on the same weights. Returns the SSD kernel's
    launches in one forward."""
    cfg = get_config("zamba2-7b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, Z_S), generator=g,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks,
             "labels": torch.randint(0, cfg.vocab_size, (1, Z_S), generator=g,
                                     device="cuda", dtype=torch.int32)}
    rec = {"params": sum(t.numel() for t in _leaves(params)),
           "shared_block_calls": len(params["groups"]),
           "mamba2_blocks": cfg.n_layers, "tokens": Z_S}
    with torch.inference_mode():
        model.forward(params, {"tokens": toks[:, :Z_Q]})        # warm-up
        rec.update(forward_and_loss(model, params, batch, ops.ssd_scan,
                                    ssd.ssd_scan_plain, "zamba2-7b"))
        kernel = rec.pop("logits")[0, :Z_CHAIN].clone()
        with plain_ssd():
            plain_path = model.forward(params, {"tokens": toks})[0, :Z_CHAIN]
        cache = model.init_cache(1, Z_CHAIN, device="cuda")
        steps = []
        t0 = time.perf_counter()
        for t in range(Z_CHAIN):
            logits, cache = model.decode_step(params, cache,
                                              toks[:, t:t + 1], t)
            steps.append(logits[0, 0])
        torch.cuda.synchronize()
        rec["decode_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / Z_CHAIN
        rec.update(chain_gaps("zamba2-7b", torch.stack(steps), kernel,
                              plain_path))
        print(json.dumps({"zamba2_forward": rec}), flush=True)
        launches = rec["forward_launches"]
        del kernel, plain_path, cache, steps, logits
    phase("zamba2 engine")
    cut = cfg.replace(n_layers=Z_ENGINE_LAYERS)
    groups = Z_ENGINE_LAYERS // cfg.shared_attn_every
    run_recurrent_engine(summary, ZAMBA2_ARGS, "zamba2-7b contiguous",
                         "ssd_scan_", {**params,
                                       "groups": params["groups"][:groups]},
                         modes=("replayed",), cfg=cut)
    return launches


def run_whisper(summary: dict) -> int:
    """Full-width whisper-large-v3 (module docstring, phase 13): forward
    and loss on [1, 1500, 1280] frames and [1, 448] tokens (32 flash
    launches each), the forward again with flash's plain version,
    ``prefill_cross_kv`` and a 64-step decode chain against both, then its
    contiguous engine on the same weights. Returns flash's launches in one
    forward."""
    cfg = get_config("whisper-large-v3")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randn(1, cfg.enc_seq, cfg.d_model, generator=g,
                         device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, W_S), generator=g,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks, "frames": frames,
             "labels": torch.randint(0, cfg.vocab_size, (1, W_S), generator=g,
                                     device="cuda", dtype=torch.int32)}
    rec = {"params": sum(t.numel() for t in _leaves(params)),
           "frames": cfg.enc_seq, "tokens": W_S}
    with torch.inference_mode():
        model.forward(params, {"tokens": toks[:, :64], "frames": frames})
        rec.update(forward_and_loss(model, params, batch, ops.flash_attention,
                                    fa.flash_attention_plain,
                                    "whisper-large-v3"))
        kernel = rec.pop("logits")[0, :W_CHAIN].clone()
        with plain_flash():
            plain_path = model.forward(params, batch)[0, :W_CHAIN]
        t0 = time.perf_counter()
        cache = encdec.prefill_cross_kv(
            cfg, params, frames, model.init_cache(1, W_CHAIN, device="cuda"))
        torch.cuda.synchronize()
        rec["prefill_cross_kv_ms"] = 1e3 * (time.perf_counter() - t0)
        steps = []
        t0 = time.perf_counter()
        for t in range(W_CHAIN):
            logits, cache = model.decode_step(params, cache,
                                              toks[:, t:t + 1], t)
            steps.append(logits[0, 0])
        torch.cuda.synchronize()
        rec["decode_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / W_CHAIN
        rec.update(chain_gaps("whisper-large-v3", torch.stack(steps), kernel,
                              plain_path))
        print(json.dumps({"whisper_forward": rec}), flush=True)
        launches = rec["forward_launches"]
        del kernel, plain_path, cache, steps, logits
    phase("whisper engine")
    run_recurrent_engine(
        summary, WHISPER_ARGS, "whisper-large-v3 contiguous", "flash_",
        {**params, "dec_layers": params["dec_layers"][:W_ENGINE_LAYERS]},
        modes=("replayed",), cfg=cfg.replace(n_layers=W_ENGINE_LAYERS))
    return launches


# ---------------------------------------------------------------------------
# gemma3-27b in bf16
# ---------------------------------------------------------------------------
#: the gemma3 engine's options (the serve CLI has no dtype flag, as the
#: reference's has none: the engine runs ``gemma3_cfg`` and serves
#: ``gemma3_requests``)
G3_ARGS = ["--arch", "gemma3-27b", "--preset", "full", "--engine",
           "continuous", "--cache", "paged", "--slots", str(G3_SLOTS),
           "--batch", str(G3_N), "--block-size", str(BS), "--prefill-lanes",
           str(G3_LANES), "--prompt-len", str(G3_LENGTHS[1] - G3_PREFIX),
           "--shared-prefix", str(G3_PREFIX), "--max-new", str(G3_NEW),
           "--max-len", str(G3_MAX_LEN), "--decode-horizon", "8", "--seed",
           "0", "--device", "cuda"]


def gemma3_cfg():
    """gemma3-27b at full width, ``G3_LAYERS`` deep, weights and
    activations bf16."""
    return get_config("gemma3-27b").replace(
        n_layers=G3_LAYERS, dtype="bfloat16", param_dtype="bfloat16")


def gemma3_requests() -> list:
    """``G3_N`` prompts of ``G3_LENGTHS`` tokens (uniform, seeded), each a
    shared ``G3_PREFIX``-token prefix and its own tail, ``G3_NEW`` new
    tokens each (the same set on every call)."""
    rng = np.random.default_rng(0)
    vocab = get_config("gemma3-27b").vocab_size
    prefix = rng.integers(1, vocab, size=G3_PREFIX).astype(np.int32)
    reqs = []
    for _ in range(G3_N):
        n = int(rng.integers(G3_LENGTHS[0], G3_LENGTHS[1] + 1)) - G3_PREFIX
        tail = rng.integers(1, vocab, size=n).astype(np.int32)
        reqs.append(ServeRequest(np.concatenate([prefix, tail]),
                                 max_new_tokens=G3_NEW))
    return reqs


def teacher_forced(cfg, params, out) -> dict:
    """Each request's first generated token against the argmax of
    ``Model.forward``'s logits at its prompt's last position (the dense
    forward's plain attention, the same weights), wherever that forward's
    top-2 margin exceeds ``G3_TOL`` of its largest |logit|; fails on a
    held mismatch, or when no request is held."""
    model, held, skipped = build_model(cfg), 0, 0
    with torch.inference_mode():
        for r in out:
            prompt = torch.as_tensor(r.prompt, dtype=torch.int32,
                                     device="cuda")[None]
            logits = model.forward(params, {"tokens": prompt})[0, -1].float()
            top = logits.topk(2).values
            if (top[0] - top[1]).item() <= G3_TOL * logits.abs().max().item():
                skipped += 1
                continue
            held += 1
            top = int(logits.argmax())
            if top != r.output[0]:
                raise SystemExit(f"FAIL: gemma3-27b: request {r.job_id}'s "
                                 f"first token {r.output[0]}, the forward's "
                                 f"argmax {top}")
    rec = {"held": held, "skipped": skipped, "margin": G3_TOL}
    print(f"gemma3-27b teacher-forced first tokens: {held} held, {skipped} "
          f"skipped (top-2 margin under {G3_TOL} of the largest |logit|)",
          flush=True)
    if not held:
        raise SystemExit("FAIL: gemma3-27b: no request's forward margin "
                         "held its first token")
    return rec


def banded_vs_scanned(cfg, params) -> dict:
    """``Model.forward`` on [1, ``G3_S``] seeded tokens with
    ``local_banded`` and without, each timed twice after a warm-up (CUDA
    events) with its peak memory; the banded logits must lie within
    ``G3_TOL`` of the scanned ones' largest |logit| (compared in slices of
    positions); argmax agreement is printed."""
    g = torch.Generator(device="cuda").manual_seed(3)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (1, G3_S),
                                     generator=g, device="cuda",
                                     dtype=torch.int32)}
    models = {"scanned": build_model(cfg),
              "banded": build_model(cfg.replace(local_banded=True))}
    ms = {k: [] for k in models}
    peak, logits = {}, {}
    with torch.inference_mode():
        for rep in range(3):                     # the first warms up
            for name, model in models.items():
                logits.pop(name, None)
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                logits[name] = model.forward(params, batch)[0]
                end.record()
                torch.cuda.synchronize()
                peak[name] = torch.cuda.max_memory_allocated()
                if rep:
                    ms[name].append(start.elapsed_time(end))
        band, scan = logits["banded"], logits["scanned"]
        scale = scan.abs().max().float().item()
        gap = max((band[i:i + 256].float() - scan[i:i + 256].float())
                  .abs().max().item() for i in range(0, G3_S, 256))
        agree = (band.argmax(-1) == scan.argmax(-1)).sum().item()
        finite = bool(torch.isfinite(band).all() and
                      torch.isfinite(scan).all())
    rec = {"tokens": G3_S, "ms": ms, "peak_bytes": peak,
           "max_abs_gap": gap, "max_abs_logit": scale,
           "gap_over_max": gap / scale, "argmax_agreement": agree,
           "positions": G3_S, "finite": finite}
    print(json.dumps({"gemma3_banded_vs_scanned": rec}), flush=True)
    if not finite or gap > G3_TOL * scale:
        raise SystemExit(f"FAIL: gemma3-27b: the banded forward's logits "
                         f"part from the scanned ones by {gap} (largest "
                         f"|logit| {scale}, tolerance {G3_TOL} of it)")
    return rec


def run_gemma3(summary: dict) -> dict:
    """gemma3-27b at full width in bf16 (module docstring, phase 13b): its
    paged engine through ``run_paged_engine``, the teacher-forced first
    tokens, and the banded forward against the scanned one. Returns each
    paged kernel's launches in the engine's captured run."""
    what = "gemma3-27b paged"
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = gemma3_cfg()
    args = serve_cli.build_parser().parse_args(G3_ARGS)
    engine, res, launches = run_paged_engine(
        summary, args, what, None, make=gemma3_requests, cfg=cfg)
    engine_peak = torch.cuda.max_memory_allocated()
    params = engine.params
    weights = _nbytes(params)
    print(f"gemma3-27b bf16 weights: {weights} bytes "
          f"({weights / 2**30:.2f} GiB), "
          f"{sum(t.numel() for t in _leaves(params))} parameters; card "
          f"total {torch.cuda.get_device_properties(0).total_memory} bytes",
          flush=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    rec = summary[what]
    rec["teacher_forced"] = teacher_forced(cfg, params,
                                           res["captured"]["out"])
    del res
    rec["banded_vs_scanned"] = banded_vs_scanned(cfg, params)
    rec.update(weight_bytes=weights, engine_peak_bytes=engine_peak,
               phase_s=time.perf_counter() - t0)
    print(json.dumps({"gemma3_phase": {k: rec[k] for k in (
        "weight_bytes", "engine_peak_bytes", "phase_s")}}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# dryrun
# ---------------------------------------------------------------------------
#: the combination the dryrun phase runs for real: qwen2-0.5b at
#: decode_32k on the one card's host mesh (1, 1), the dry-run's bf16
DRY_ARCH, DRY_SHAPE = "qwen2-0.5b", "decode_32k"
#: the share of the card's memory the dry-run's predicted peak must stay
#: under for a depth to run; the step's timed repetitions
DRY_FIT, DRY_REPS = 0.9, 3
#: the checks' tolerances: argument bytes placed, the measured peak
DRY_ARG_TOL, DRY_PEAK_TOL = 0.01, 0.25
#: the least step time against the arguments over HBM bandwidth, and
#: against the dry-run's memory_s
DRY_ARGS_FLOOR, DRY_MEMORY_FLOOR = 0.9, 0.7


def _dry_line(rec) -> str:
    return (f"args {rec['args_gib_per_device']:.3f} GiB a GPU, compute "
            f"{1e3 * rec['compute_s']:.4f} ms, memory "
            f"{1e3 * rec['memory_s']:.4f} ms, collective "
            f"{1e3 * rec['collective_s']:.4f} ms: {rec['bottleneck']}")


def _fail_dry(what: str) -> None:
    raise SystemExit(f"FAIL: dryrun: {what}")


def run_dryrun() -> dict:
    """Phase ``dryrun`` (module docstring, phase 14): the dry-run's sweep
    at decode_32k on the pod mesh, then one record made real on the card
    and held to what it predicted, as the reference's config has it and
    with ``gqa_no_repeat``."""
    for arch in ARCH_IDS:
        rec, _ = dryrun.lower_combo(arch, DRY_SHAPE, False, probe=False)
        print(f"dryrun {arch} {DRY_SHAPE} pod {rec['mesh_shape']}: "
              f"{_dry_line(rec)}", flush=True)
    out = {name: dry_on_card(name, knobs) for name, knobs in DRY_KNOBS}
    base, grouped = (out[name] for name, _ in DRY_KNOBS)
    print(f"dryrun {DRY_ARCH} {DRY_SHAPE}: gqa_no_repeat step "
          f"{grouped['step_ms']:.3f} ms against {base['step_ms']:.3f} "
          f"({grouped['step_ms'] / base['step_ms']:.4f}x), peak "
          f"{grouped['peak_bytes']} against {base['peak_bytes']} bytes, "
          f"dry-run bytes {grouped['bytes_per_chip']:.0f} against "
          f"{base['bytes_per_chip']:.0f}", flush=True)
    return out


#: the dryrun phase's two records made real: the reference config's, and
#: with the KV repeat of ``mha`` removed (``gqa_no_repeat``)
DRY_KNOBS = (("repeat", {}), ("gqa_no_repeat", {"gqa_no_repeat": True}))


def dry_on_card(name: str, knobs: dict) -> dict:
    """``DRY_ARCH`` at ``DRY_SHAPE`` with ``knobs`` on the card's host mesh
    (1, 1) at the largest depth whose predicted peak fits, made real and
    held to its record (module docstring, phase 14)."""
    total = torch.cuda.get_device_properties(0).total_memory
    full = get_config(DRY_ARCH).n_layers
    for n_layers in range(full, 0, -1):
        extra = dict(knobs, **({} if n_layers == full
                               else {"n_layers": n_layers}))
        rec, prog = dryrun.lower_combo(DRY_ARCH, DRY_SHAPE, False,
                                       probe=False, mesh_kind="host",
                                       ranks=1, extra_cfg=extra or None)
        if rec["memory_stats"]["peak_bytes"] < DRY_FIT * total:
            break
        print(f"dryrun {name}: {n_layers} layers predict a peak of "
              f"{rec['memory_stats']['peak_bytes']} bytes, over "
              f"{DRY_FIT} of the card's {total}", flush=True)
    else:
        _fail_dry(f"{name}: no depth fits the card")
    mem = rec["memory_stats"]
    print(f"dryrun {DRY_ARCH} {DRY_SHAPE} {name} host {rec['mesh_shape']}, "
          f"{n_layers} of {full} layers (predicted peak {mem['peak_bytes']} "
          f"bytes, {mem['peak_bytes'] / total:.4f} of {total}): "
          f"{_dry_line(rec)}", flush=True)
    if rec["kernels"] or rec["n_chips"] != 1:
        _fail_dry(f"{name}: the record runs kernels {sorted(rec['kernels'])} "
                  f"on {rec['n_chips']} GPUs")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = materialize(prog.args, gen, prog.cfg.vocab_size)
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - base
    out = {"knobs": knobs, "layers": n_layers,
           "argument_bytes": mem["argument_bytes"], "placed_bytes": placed}
    if abs(placed - mem["argument_bytes"]) > DRY_ARG_TOL * mem[
            "argument_bytes"]:
        _fail_dry(f"{name}: {placed} bytes placed against argument_bytes "
                  f"{mem['argument_bytes']}")

    with prog.rules():
        logits, _ = prog.run(*args)       # warm-up
        want = (args[-1].shape[0], 1, prog.cfg.vocab_size)
        if (tuple(logits.shape) != want
                or not torch.isfinite(logits).all()):
            _fail_dry(f"{name}: logits {tuple(logits.shape)} not finite or "
                      f"not {list(want)}")
        del logits
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(DRY_REPS)]
        for s_ev, e_ev in ev:
            s_ev.record()
            prog.run(*args)
            e_ev.record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        with FlopCounterMode(display=False) as fc:
            prog.run(*args)
        flops = fc.get_total_flops()
    step_s = statistics.median(s.elapsed_time(e) for s, e in ev) / 1e3
    out.update(step_ms=1e3 * step_s, memory_s=rec["memory_s"],
               step_over_memory_s=step_s / rec["memory_s"],
               flops=flops, dry_flops=rec["flops_per_chip"],
               peak_bytes=peak, dry_peak_bytes=mem["peak_bytes"],
               peak_ratio=peak / mem["peak_bytes"],
               bytes_per_chip=rec["bytes_per_chip"])
    print(f"dryrun {name} on the card: step {1e3 * step_s:.3f} ms (median "
          f"of {DRY_REPS}), memory_s {1e3 * rec['memory_s']:.3f} ms, ratio "
          f"{step_s / rec['memory_s']:.4f}; peak {peak} bytes against the "
          f"dry-run's {mem['peak_bytes']} ({peak / mem['peak_bytes']:.4f}); "
          f"FLOPs {flops} against {rec['flops_per_chip']:.0f}; arguments "
          f"{placed} bytes placed against {mem['argument_bytes']}; dry-run "
          f"bytes {rec['bytes_per_chip']:.0f}", flush=True)
    print(json.dumps({"dryrun_phase": out}), flush=True)
    del args
    gc.collect()
    torch.cuda.empty_cache()
    if flops != rec["flops_per_chip"]:
        _fail_dry(f"{name}: the card's step counts {flops} FLOPs, the "
                  f"dry-run {rec['flops_per_chip']}")
    if step_s < DRY_ARGS_FLOOR * mem["argument_bytes"] / HBM_BPS:
        _fail_dry(f"{name}: a step of {step_s} s is under {DRY_ARGS_FLOOR} "
                  f"x the arguments' {mem['argument_bytes']} bytes over HBM")
    if step_s < DRY_MEMORY_FLOOR * rec["memory_s"]:
        _fail_dry(f"{name}: a step of {step_s} s is under "
                  f"{DRY_MEMORY_FLOOR} x the dry-run's memory_s "
                  f"{rec['memory_s']} s: the byte count counts too much")
    if abs(peak / mem["peak_bytes"] - 1) > DRY_PEAK_TOL:
        _fail_dry(f"{name}: the measured peak {peak} is not within "
                  f"{DRY_PEAK_TOL} of the dry-run's {mem['peak_bytes']}")
    return out


# ---------------------------------------------------------------------------
# sharded
# ---------------------------------------------------------------------------
def _recurrent(cfg) -> bool:
    """Whether ``cfg`` serves on the recurrent engines (its prefill steps
    the decode): the SSM, hybrid and encdec families."""
    return cfg.family in ("ssm", "hybrid", "encdec")


def _shard_slots(cfg) -> tuple:
    """(slots, max_len) of the sharded phase's engine of ``cfg``."""
    if _recurrent(cfg):
        return REC_SHARD_SLOTS, REC_SHARD_MAX_LEN
    return SLOTS, MAX_LEN


def shard_engine(cfg, device, plan=None, params=None, cache="paged"):
    """The sharded phase's engine (the engine phase's options; the
    contiguous one at the same slots, max_len and horizon; the recurrent
    families' at ``REC_SHARD_*``) on ``device``; weights drawn from seed 0
    unless given."""
    slots, max_len = _shard_slots(cfg)
    return ServeEngine(cfg, params=params, max_len=max_len, n_slots=slots,
                       cache=cache, block_size=BS, prefill_lanes=4,
                       decode_horizon=8, device=device, seed=0,
                       sharding=plan)


def shard_requests(cfg, rate: float, cache: str = "paged"):
    """The engine phase's request set (its prompts and shared prefix), cut
    to ``SHARD_N`` requests of ``SHARD_NEW`` new tokens; the contiguous
    runs': prompts of the ``SEQ_PROMPTS`` lengths (multiples of 4) drawn
    from seed 0; the recurrent families': ``REC_SHARD_N`` prompts of 8-16
    tokens and budgets of 4-12, drawn from seed 0. A ``rate`` spaces the
    paged and contiguous sets' arrivals at 1 / rate steps."""
    rng = np.random.default_rng(0)
    if _recurrent(cfg):
        lengths = rng.integers(8, 17, size=REC_SHARD_N)
        budgets = rng.integers(4, 13, size=REC_SHARD_N)
        return [ServeRequest(rng.integers(1, cfg.vocab_size, size=int(n))
                             .astype(np.int32), max_new_tokens=int(m),
                             arrival_time=0.0)
                for n, m in zip(lengths, budgets)]
    if cache == "paged":
        return serve_cli.make_requests(cfg, SHARD_N, 256, SHARD_NEW, rate,
                                       seed=0, shared_prefix=64)
    return [ServeRequest(rng.integers(1, cfg.vocab_size, size=n)
                         .astype(np.int32), max_new_tokens=SHARD_NEW,
                         arrival_time=i / rate if rate else 0.0)
            for i, n in enumerate(SEQ_PROMPTS)]


#: the sharded phase's runs: (name, arch, mesh shape, layers, arrival
#: rate, cache), by process group size
SHARD_RUNS = {
    2: (("tp", "qwen2-0.5b", (1, 2), Q_ENGINE_LAYERS, 0.0, "paged"),
        ("dp", "qwen2-0.5b", (2, 1), Q_ENGINE_LAYERS, SHARD_DP_RATE,
         "paged"),
        ("dp-contiguous", "qwen2-0.5b", (2, 1), Q_ENGINE_LAYERS,
         SHARD_DP_RATE, "contiguous"),
        ("mamba2", "mamba2-780m", (1, 2), M2_SHARD_LAYERS, 0.0,
         "contiguous"),
        ("dp-mamba2", "mamba2-780m", (2, 1), M2_DP_SHARD_LAYERS, 0.0,
         "contiguous"),
        ("zamba2", "zamba2-7b", (1, 2), Z_SHARD_LAYERS, 0.0, "contiguous"),
        ("whisper", "whisper-large-v3", (1, 2), W_SHARD_LAYERS, 0.0,
         "contiguous")),
    SEQ_M: (("kv-seq", "qwen2-0.5b", (1, SEQ_M), SEQ_PAGED_LAYERS, 0.0,
             "paged"),
            ("q-seq", "qwen2-0.5b", (1, SEQ_M), SEQ_CONTIG_LAYERS, 0.0,
             "contiguous")),
}
#: the kernels each run's ranks must launch (ops counter names; the
#: recurrent engines reach none, as in the reference, and neither does the
#: dense contiguous engine: its prefill and decode attend through plain
#: mha, as the reference's dense forward does)
SHARD_KERNELS = {
    "tp": ("paged_attention", "paged_prefill_attention"),
    "dp": ("paged_attention", "paged_prefill_attention"),
    "dp-contiguous": (), "dp-mamba2": (),
    "kv-seq": ("paged_attention_partial", "paged_prefill_partial"),
    "q-seq": ("flash_attention_offset",),
    "mamba2": (), "zamba2": (), "whisper": (),
}


def _shard_cfg(arch, layers):
    cfg = get_config(arch)
    return cfg if layers is None else cfg.replace(n_layers=layers)


def _shard_run(engine, cfg, rate: float, cache: str = "paged") -> dict:
    """One run of the phase's request set, counters set to 0 just before
    and read just after."""
    from repro_torch.dist import sharding as shd
    reqs = shard_requests(cfg, rate, cache)
    ops.set_counts((0,) * len(ops.COUNTERS))
    shd.reset_stats()
    torch.cuda.synchronize()
    out, stats = engine.run(reqs)
    torch.cuda.synchronize()
    bufs = engine.pool.buffers
    return dict(tokens=[list(map(int, r.output)) for r in out],
                launches=dict(zip(COUNTER_NAMES, ops.counts())),
                collectives=dict(shd.STATS),
                graphs="eager" if engine.graphs.is_eager else "captured",
                steps=stats.steps, decode_s=stats.decode_s,
                wall_s=stats.wall_s, decode_rows_saved=stats.decode_rows_saved,
                decode_dispatches=stats.decode_dispatches,
                prefill_dispatches=stats.prefill_dispatches,
                # the host loop's decode rows (a bucket's rows times its
                # steps), as decode_rows_saved derives from them
                rows_dispatched=round((1.0 - stats.decode_rows_saved)
                                      * stats.steps * engine.pool.n_slots),
                work=dict(engine.work),
                pool={k: [list(bufs[k].shape),
                          bufs[k].numel() * bufs[k].element_size()]
                      for k in ("k", "v")} if cache == "paged" else
                {k: [list(t.shape), t.numel() * t.element_size()]
                 for k, t in bufs.items()},
                pool_axes=getattr(engine.pool, "batch_axes", None))


def _tp_forward(cfg, plan) -> dict:
    """mamba2-780m's ``Model.forward`` on [1, M2_SHARD_S] tokens, single
    process on the seed-0 weights and then on this rank's blocks of them
    under the plan's rules (counters set to 0 just before the sharded
    forward and read just after; the heads each block's SSD scan takes,
    read from its local ``A_log``)."""
    from repro_torch.dist import sharding as shd
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, M2_SHARD_S),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1), device="cuda", dtype=torch.int32)
    local = plan.shard_params(params)
    # the heads each block hands the scan: its local A_log's (mamba2._blocks)
    heads = sorted({int(p["A_log"].shape[0]) for p in local["layers"]})
    with torch.inference_mode():
        model.forward(params, {"tokens": toks})      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        off = model.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        single_ms = 1e3 * (time.perf_counter() - t0)
        with plain_ssd():           # the same function, other roundings
            plain_gap = float((model.forward(params, {"tokens": toks})
                               - off).abs().max())
        del params
        ops.set_counts((0,) * len(ops.COUNTERS))
        shd.reset_stats()
        t0 = time.perf_counter()
        with plan.rules():
            on = model.forward(local, {"tokens": toks})
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = dict(zip(COUNTER_NAMES, ops.counts()))
        return dict(launches=launches, heads=heads, shape=tuple(on.shape),
                    plain_gap=plain_gap,
                    finite=bool(torch.isfinite(on).all()),
                    max_abs=float((on - off).abs().max()),
                    scale=float(off.abs().max()), ms=ms,
                    single_ms=single_ms, collectives=dict(shd.STATS))


def _shard_rank(rank: int, port: int, world: int, runs, queue) -> None:
    """One rank process: join the ``world``-rank gloo group on cuda:0,
    serve each of ``runs`` ((name, mesh shape, layers, arrival rate,
    cache)) on its mesh, put (rank, results or the error) on ``queue``."""
    import traceback
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.dist.sharding import Mesh
    from repro_torch.serve.sharded import make_serve_sharding
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.library()
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=300))
        res = {}
        for name, arch, shape, layers, rate, cache in runs:
            cfg = _shard_cfg(arch, layers)
            mesh = Mesh(shape, ("data", "model"), DeviceMesh(
                SHARD_DEVICE, torch.arange(world).reshape(shape),
                mesh_dim_names=("data", "model")))
            slots, max_len = _shard_slots(cfg)
            plan = make_serve_sharding(cfg, slots, max_len, mesh,
                                       cache=cache, block_size=BS)
            engine = shard_engine(cfg, SHARD_DEVICE, plan, cache=cache)
            res[name] = _shard_run(engine, cfg, rate, cache)
            res[name]["held_replicated"] = list(plan.held_replicated)
            res[name]["backend"] = plan.backend
            res[name]["cache_seq"] = plan.cache_seq_axis
            del engine
            gc.collect()
            torch.cuda.empty_cache()
            if name == "mamba2":
                res["mamba2 forward"] = _tp_forward(cfg, plan)
                gc.collect()
                torch.cuda.empty_cache()
        dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _shard_group(world: int, params) -> tuple:
    """Spawn ``world`` rank processes serving ``SHARD_RUNS[world]`` and run
    the same engines single-process under ``graphs.eager()`` meanwhile, on
    the same weights. Returns (each rank's results, the single runs)."""
    import socket
    import torch.multiprocessing as mp
    runs = SHARD_RUNS[world]
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_shard_rank,
                         args=(r, port, world, runs, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        single = {}
        for name, arch, _, layers, rate, cache in runs:
            cfg = _shard_cfg(arch, layers)
            # qwen2 on the engine phase's weights; the others drawn from
            # seed 0, as the ranks draw them
            sub = (dict(params, layers=params["layers"][:cfg.n_layers])
                   if arch == "qwen2-0.5b" else None)
            with graphs.eager():
                single[name] = _shard_run(
                    shard_engine(cfg, "cuda", params=sub, cache=cache), cfg,
                    rate, cache)
            gc.collect()
            torch.cuda.empty_cache()
        ranks = {}
        while len(ranks) < len(procs):      # stop at the first failure
            r, res = queue.get(timeout=SHARD_TIMEOUT)
            ranks[r] = res
            if "error" in res:
                break
        for p in procs:
            p.join(timeout=60 if len(ranks) == len(procs) else 1)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    failed = {r: v["error"] for r, v in ranks.items() if "error" in v}
    if failed or len(ranks) < len(procs) or any(p.exitcode for p in procs):
        raise SystemExit(f"FAIL: sharded: rank(s) of {world} failed "
                         f"{[p.exitcode for p in procs]}: {failed}")
    return [ranks[r] for r in range(world)], single


def check_tp_forward(ranks, cfg, shape) -> int:
    """Each rank's tensor-parallel mamba2-780m forward (``_tp_forward``):
    the SSD kernel launched once a layer at the rank's heads and never its
    plain version, collectives issued, logits finite and within
    ``M2_SHARD_TOL`` of the largest |logit| of the single-process forward
    (printed beside the single-process forward's gap to itself with the
    plain scan). Returns the launches summed over the ranks."""
    what = f"sharded mamba2-780m forward [1, {M2_SHARD_S}] mesh {shape}"
    heads = cfg.n_ssm_heads // shape[1]
    for r, x in enumerate(ranks):
        calls = {k: v for k, v in x["launches"].items() if v}
        print(json.dumps({"sharded_forward": what, "rank": r, **{
            k: x[k] for k in ("launches", "heads", "max_abs",
                              "plain_gap", "scale", "ms", "single_ms",
                              "collectives")}}),
              flush=True)
        if (x["launches"]["ssd_scan"] != cfg.n_layers
                or x["heads"] != [heads]
                or any(k.endswith("_plain") for k in calls)):
            raise SystemExit(f"FAIL: {what}: rank {r} launches {calls} at "
                             f"{x['heads']} heads, not ssd_scan "
                             f"{cfg.n_layers} times at {heads}")
        if not (x["collectives"]["all_reduce"] > 0
                and x["collectives"]["all_gather"] > 0):
            raise SystemExit(f"FAIL: {what}: rank {r} issued "
                             f"{x['collectives']}")
        if not x["finite"] or x["max_abs"] > M2_SHARD_TOL * x["scale"]:
            raise SystemExit(f"FAIL: {what}: rank {r} logits "
                             f"{x['max_abs']:.3e} from the single-process "
                             f"forward's (largest |logit| {x['scale']:.3e})"
                             f", finite {x['finite']}")
    return sum(x["launches"]["ssd_scan"] for x in ranks)


def run_sharded(summary: dict, params) -> dict:
    """The sharded phase (module docstring): two ranks on meshes (1, 2)
    and (2, 1) (qwen2-0.5b paged on both and contiguous on (2, 1), then
    mamba2-780m on both, zamba2-7b and whisper-large-v3 on (1, 2) and
    mamba2-780m's forward), then four on (1, 4). Returns, by kernel, the
    launches summed over the ranks of the qwen2 runs and of the mamba2
    forward, by path."""
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rec = {"card": smi}
    paths = {}
    for world in SHARD_RUNS:
        ranks, single = _shard_group(world, params)
        for name, arch, shape, layers, rate, cache in SHARD_RUNS[world]:
            cfg = _shard_cfg(arch, layers)
            layers = cfg.n_layers
            ref, got = single[name], [x[name] for x in ranks]
            what = (f"sharded {name} {arch} mesh {shape} {cache} at {layers} "
                    "layers")
            if any(x["tokens"] != ref["tokens"] for x in got):
                raise SystemExit(f"FAIL: {what}: the ranks' tokens differ "
                                 "from each other or from the "
                                 "single-process run")
            for r, x in enumerate(got):
                calls = {k: v for k, v in x["launches"].items() if v}
                c = x["collectives"]
                if (any(x["launches"][k] <= 0 for k in SHARD_KERNELS[name])
                        or any(k.endswith("_plain") for k in calls)
                        or x["graphs"] != "eager" or x["backend"] != "gloo"
                        or not (c["all_reduce"] > 0 or c["all_gather"] > 0)):
                    raise SystemExit(f"FAIL: {what}: rank {r} launches "
                                     f"{calls}, graphs {x['graphs']}, "
                                     f"{x['backend']}, collectives {c}")
                if x["held_replicated"]:
                    raise SystemExit(f"FAIL: {what}: rank {r} holds "
                                     f"{x['held_replicated']} whole")
                if cache == "contiguous" and any(
                        shp[x["pool_axes"][k]] != _shard_slots(cfg)[0]
                        // shape[0] for k, (shp, _) in x["pool"].items()):
                    raise SystemExit(f"FAIL: {what}: rank {r}'s pool "
                                     f"{x['pool']} does not hold "
                                     f"{_shard_slots(cfg)[0]} / {shape[0]} "
                                     "slots")
                print(json.dumps({"sharded_rank": name, "rank": r,
                                  "pool": x["pool"], "work": x["work"]}),
                      flush=True)
                if world == SEQ_M and x["cache_seq"] != "model":
                    raise SystemExit(
                        f"FAIL: {what}: rank {r}'s pool positions split "
                        f"over {x['cache_seq']}")
                if (_recurrent(cfg) and shape[1] > 1
                        and not (c["all_reduce"] > 0
                                 and c["all_gather"] > 0)):
                    raise SystemExit(f"FAIL: {what}: rank {r} computes "
                                     f"whole: collectives {c}")
            if name == "dp" and not (got[0]["decode_rows_saved"] > 0 and all(
                    x["work"].get("lanes", 0) > 0 for x in got)):
                raise SystemExit(f"FAIL: {what}: no decode rows saved, or "
                                 "no prefill round split over 'data'")
            # the 'data' ranks' parts, plus what every one computed whole,
            # are the run's: tokens and prefill lanes the single-process
            # run's, decode rows the host loop's (whose buckets round up to
            # a multiple of 'data')
            data = got[::shape[1]]
            work = {k: sum(x["work"].get(k, 0) for x in data)
                    + data[0]["work"].get(k + "_whole", 0)
                    for k in ("rows", "tokens", "lanes")}
            want = {"rows": got[0]["rows_dispatched"],
                    "tokens": ref["work"]["tokens"],
                    "lanes": ref["work"]["lanes"]}
            if work != want:
                raise SystemExit(f"FAIL: {what}: the ranks' work {work} is "
                                 f"not the run's {want}")
            a = got[0]
            rec[name] = {
                "arch": arch, "mesh": shape, "cache": cache,
                "layers": layers, "arrival_rate": rate,
                "tokens": sum(len(t) for t in ref["tokens"]),
                "steps": a["steps"],
                "decode_dispatches": a["decode_dispatches"],
                "prefill_dispatches": a["prefill_dispatches"],
                "decode_rows_saved": a["decode_rows_saved"],
                "collectives": [x["collectives"] for x in got],
                "collective_share_of_wall": [
                    x["collectives"]["seconds"] / x["wall_s"] for x in got],
                "launches": [{k: v for k, v in x["launches"].items() if v}
                             for x in got],
                "held_replicated": a["held_replicated"],
                "cache_seq": a["cache_seq"],
                "work": [x["work"] for x in got],
                "single_work": ref["work"],
                "rows_dispatched": a["rows_dispatched"],
                "pool_bytes": [sum(b for _, b in x["pool"].values())
                               for x in got],
                "single_pool_bytes": sum(b for _, b in
                                         ref["pool"].values()),
                "decode_ms_per_step": [1e3 * x["decode_s"] / x["steps"]
                                       for x in got],
                "single_decode_ms_per_step": (1e3 * ref["decode_s"]
                                              / ref["steps"]),
                "wall_s": [x["wall_s"] for x in got],
                "single_wall_s": ref["wall_s"]}
            print(json.dumps({"sharded": name, **rec[name]}), flush=True)
            print(f"sharded {name}: collectives a rank "
                  f"{[{k: v for k, v in c.items() if k != 'seconds'} for c in rec[name]['collectives']]}; "
                  f"decode ms a step {rec[name]['decode_ms_per_step']} "
                  f"against single-process eager "
                  f"{rec[name]['single_decode_ms_per_step']:.3f}; gloo "
                  f"{rec[name]['collective_share_of_wall']} of the wall "
                  f"({smi})", flush=True)
            if name in ("tp", "dp", "dp-contiguous", "kv-seq", "q-seq"):
                path = (f"qwen2-0.5b sharded {cache} ({world} ranks, mesh "
                        f"{shape})")
                for kern, counter in (
                        ("flash_attention", "flash_attention"),
                        ("paged_decode", "paged_attention"),
                        ("paged_prefill", "paged_prefill_attention"),
                        ("paged_decode_partial", "paged_attention_partial"),
                        ("paged_prefill_partial", "paged_prefill_partial"),
                        ("flash_attention_offset",
                         "flash_attention_offset")):
                    n = sum(x["launches"][counter] for x in got)
                    if n:
                        paths.setdefault(kern, {})[path] = n
            if name == "mamba2":
                fw = [x["mamba2 forward"] for x in ranks]
                n = check_tp_forward(fw, cfg, shape)
                paths.setdefault("ssd_scan", {})[
                    f"mamba2-780m sharded forward ({world} ranks, mesh "
                    f"{shape})"] = n
                rec["mamba2 forward"] = {
                    k: [x[k] for x in fw] for k in (
                        "heads", "max_abs", "plain_gap", "scale", "ms",
                        "single_ms")}
                rec["mamba2 forward"]["launches"] = n
    rec["phase_s"] = time.perf_counter() - t0
    print(f"sharded: every run's tokens agree across the ranks and with the "
          f"single-process eager runs ({smi}); phase {rec['phase_s']:.1f} s",
          flush=True)
    summary["sharded"] = rec
    return paths


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; chip_smoke.py needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: {kind} x "
          f"{count}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    lib, ptxas = build.build()
    print(f"{lib} in {time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas(ptxas)
    check_tensor_cores(lib)
    build.library()

    phase("kernels")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rec = check_kernels(flush)
    check_splits(flush, "paged_decode")
    check_splits(flush, "paged_prefill")
    check_engine_shapes(flush, rec)
    rec["flash_attention"] = check_flash(flush)
    rec["grouped_matmul"] = check_grouped_matmul(flush)
    rec["ssd_scan"] = check_ssd(flush)
    (rec["flash_attention_backward"],
     rec["flash_attention_backward_bf16"]) = check_flash_backward(flush)
    rec["ssd_scan_backward"] = check_ssd_backward(flush)
    rec.update(check_partial(flush))
    rec["flash_attention_offset"] = check_flash_offset(flush)
    del flush
    torch.cuda.empty_cache()

    phase("reference")
    check_reference()

    phase("engine")
    summary = {}
    #: each kernel's launches in the captured run of each path
    paths = {name: {} for name in rec}
    # and the profile and sampled phases
    launches, params, untraced = run_engine(summary)
    for name, n in launches.items():
        paths[name]["qwen2-0.5b paged"] = n

    phase("chaos")
    launches, chaos = run_chaos(summary, params)
    for name, n in launches.items():
        paths[name]["qwen2-0.5b chaos"] = n

    phase("obs")
    for name, n in run_obs(summary, params, untraced, chaos).items():
        paths[name]["qwen2-0.5b traced"] = n
    del untraced, chaos

    phase("sharded")
    gc.collect()
    torch.cuda.empty_cache()
    for name, by_path in run_sharded(summary, params).items():
        paths[name].update(by_path)
    del params

    phase("olmoe")
    gc.collect()                    # the qwen2 engines are gone: free them
    torch.cuda.empty_cache()
    launches, params = run_olmoe(summary)
    for name in ("flash_attention", "grouped_matmul"):
        paths[name]["olmoe-1b-7b contiguous"] = launches[name]

    phase("olmoe paged")
    for name, n in run_olmoe_paged(summary, params).items():
        paths[name]["olmoe-1b-7b paged"] = n
    del params
    gc.collect()                    # the olmoe engines are gone: free them
    torch.cuda.empty_cache()

    phase("phi-3-vision")
    phi, model, params = run_phi3(summary)
    paths["flash_attention"]["phi-3-vision-4.2b forward"] = phi["forward"]
    for name, n in phi["paged"].items():
        paths[name]["phi-3-vision-4.2b paged"] = n
    gc.collect()                    # the phi-3-vision engine is gone
    torch.cuda.empty_cache()

    phase("synergy")
    del model, params               # the trainer draws its own, seeded
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for name, n in run_synergy().items():
        paths[name]["phi-3-vision-4.2b synergy train"] = n
    print(f"synergy phase {time.perf_counter() - t0:.1f} s", flush=True)

    phase("train-bf16")
    gc.collect()
    torch.cuda.empty_cache()
    counts = run_train_bf16()
    path = "phi-3-vision-4.2b train bf16"
    paths["flash_attention"][path] = counts["flash_attention"]
    paths["flash_attention_backward_bf16"][path] = counts[
        "flash_attention_backward"]

    phase("mamba2")
    paths["ssd_scan"]["mamba2-780m forward"] = run_mamba2()
    gc.collect()
    torch.cuda.empty_cache()

    phase("mamba2 engine")
    run_mamba2_engine(summary)
    gc.collect()
    torch.cuda.empty_cache()

    phase("train")
    t0 = time.perf_counter()
    counts = run_train()
    for name in ("ssd_scan", "ssd_scan_backward"):
        paths[name]["mamba2-780m train"] = counts[name]
    print(f"train phase {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    phase("runtime")
    t0 = time.perf_counter()
    counts = run_runtime()
    for name in ("flash_attention", "ssd_scan", "flash_attention_backward",
                 "ssd_scan_backward"):
        paths[name]["live runtime"] = counts[name]
    print(f"runtime phase {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    phase("zamba2")
    paths["ssd_scan"]["zamba2-7b forward"] = run_zamba2(summary)
    gc.collect()                    # the zamba2 engine and weights are gone
    torch.cuda.empty_cache()

    phase("whisper")
    paths["flash_attention"]["whisper-large-v3 forward"] = run_whisper(
        summary)
    gc.collect()
    torch.cuda.empty_cache()

    phase("gemma3-27b")
    for name, n in run_gemma3(summary).items():
        paths[name]["gemma3-27b paged"] = n
    gc.collect()
    torch.cuda.empty_cache()

    phase("dryrun")
    t0 = time.perf_counter()
    run_dryrun()
    print(f"dryrun phase {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    phase("summary")
    print(json.dumps({"graphs_vs_eager": summary}), flush=True)

    unread = [name for name, by_path in paths.items() if not by_path]
    if unread:
        raise SystemExit(f"FAIL: no engine run counted the launches of "
                         f"{unread}")
    for name, by_path in paths.items():
        rec[name]["launches"] = sum(by_path.values())
        rec[name]["launches_by_path"] = by_path
    print(json.dumps({"kernels": list(rec.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
