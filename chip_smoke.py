#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (horovod_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases kernels   # a subset, for debugging
    python3 chip_smoke.py --out-dir DIR      # profile files (default
                                             # build/chip_smoke/)

Phases, in order; any failure exits non-zero and prints no result line:

1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
             versions.
2. build   - nvcc builds the flash-attention kernels from
             horovod_tpu_torch/ops/csrc.
3. kernels - each kernel against its plain PyTorch version on the same
             inputs on the card, at the training shape (b8 h12 s1024 d64,
             causal, bf16) and at edge cases (ragged ends across a
             128-row tile, offsets that are not tile-aligned, masked rows,
             both kernel forms: the Hopper redesign of all three kernels
             for bf16 at head_dim 64 to 128, the first form for the
             rest); times of the
             kernel, the plain version and torch's
             scaled_dot_product_attention pinned to its FLASH_ATTENTION
             backend (a yardstick the port never calls), the card's bound,
             and the host time of one TMA tensor-map encode.
4. long    - the same comparison at b1 h12 s8192 d64 (the sequence regime
             of the TPU's streaming kernels).
5. trainer - the port's main path: init -> broadcast_parameters ->
             DistributedOptimizer(AdamW) -> make_train_step on GPT-2-small
             (bf16, batch 8, seq 1024), 2 warm-up and 5 timed steps; the
             loss must fall, every kernel must launch n_layers times a
             step, and the profiled step must show each redesigned
             kernel (forward, dK/dV, dQ) n_layers times and none of the
             first form's.
6. gpt3_large - GPT-3 Large (Brown et al. 2020, Table 2.1: d_model
             1536, 16 heads of 96, 24 layers, d_ff 6144, n_ctx 2048, vocab
             50257, bf16; 837,347,328 parameters, no cut): first the
             flash kernels against their plain versions at head_dim 96
             and 80 (b4 h16 s2048 d96 and b1 h32 s2048 d80 causal bf16,
             f32 at d96 on the first form, s8192 d96, ragged, offset and
             masked edges) and cache_attention at hd 96 (decode b8 s2
             over a capacity of 2048, prefill b1 s2000) and the logits
             product at vocab 50257 (serving_gemm's first form), timed
             beside the bound, the plain version and the library call;
             then transformer_lm.train at batch 4 x 2048 (2 warm-up and 3
             timed steps: the loss falling, each flash kernel 24 times a
             step, the profiled step on the Hopper forms only); then the
             trained weights served (8 slots, page 16, capacity 2048):
             prefill + decode bitwise serving_forward at 7, 300 and 2000
             tokens, 8 prompts of 64-1900 tokens continuous and static
             with the same tokens, cache_attention on its Hopper form,
             one first-form logits product a forward_step, no flash
             launch.
7. eager   - first, cProfile of 1,000 synchronous 4-byte negotiated
             allreduces (tools/negotiation_profile.py) on the CPU and on
             the card, the response cache off and on; then the
             negotiated collectives on one rank with NCCL, and the
             hook-driven horovod.torch DistributedOptimizer: every
             collective (allreduce Sum/Average/Min/Max/Product, a grouped
             allreduce fused into one response, ragged allgather,
             broadcast, alltoall with splits, reducescatter, a process
             set, join) in float32, bfloat16, float16 and int32 against
             plain torch on the card; a stream-order check (a 256 MB
             tensor written on a side stream, allreduce_async_ right
             after, 20 times, exact); Adasum on one rank (the input back
             exactly in f32/bf16/f16, int32 refused) and the feature
             queries; GPT-2-small through examples/transformer_lm.py's
             hook path held bitwise to the monolithic make_train_step,
             and with the response cache on to off, over 3 steps from
             the same init and batches; timed in turns (monolithic,
             hook, hook with the cache off twice, hook, monolithic; 2
             warm-up and 5 timed steps each), each flash kernel 12 times
             a step; step ms, tokens/s, negotiated tensors, cache hits
             and misses (18 hits, 0 misses a step with the cache),
             fused responses (the same with the cache off) and NCCL
             calls a step; one profiled step (idle share, whether the
             executor's first device work starts before the last dQ
             kernel); one step under start_timeline/stop_timeline (the
             file parses; each of the 18 tensors has its NEGOTIATE span,
             its top-level span marked cache hit or miss, and its
             NCCL_ALLREDUCE activity); the latency of a 4-byte and a
             64 MB negotiated allreduce with the cache on, off, off, on
             (a fixed name; the 4-byte one also unnamed, which the cache
             never serves); native_built() true, then the hook step and
             the named 4 B / 64 MB latencies with the native coordinator
             and with HVD_TPU_DISABLE_NATIVE=1 in turns (native, python,
             python, native): the hook path bitwise equal, the same fused
             responses and cache hits a step.
8. quant   - the quantized allreduce's codec kernels (ops/csrc/quant.cu:
             quant_pack, unpack_dequantize) against their plain PyTorch
             versions on the card, bitwise (torch.equal of the bytes), at
             the embedding's bucket (25,165,824 elements) and a 64 MB
             bucket, int8 and int4, stochastic and nearest, f32, bf16 and
             f16 inputs, in quant_pack's both forms (the one pass and the
             first form), with an all-zero block, a block with one huge
             value, f32 subnormals, NaN, +inf, -inf and NaN-and-inf
             blocks, r = 4 with a row sum; then every block from 6 (the
             first form) to 1024, r = 4 rows of C = 768, 1536 and 4096
             (2-, 4- and 8-byte code stores), with and without the
             residual, and rows one element off 16-byte alignment (the
             first form), each launch counted in the form quant_pack_form
             picks; each kernel and its plain version timed (int8
             stochastic, bf16 and f32; quant_pack's two forms in turns,
             first, one pass, one pass, first, and the one pass must be
             the faster) with the bound (bytes / 3.35 TB/s; for
             quant_pack the larger of that and its operations an
             element, counted in the function: its rotates and logic ops
             over 64 ALU lanes or all its ops over 128 issue lanes an
             SM, whichever is more, at the SM clock nvidia-smi reads
             under its load; both forms' SASS counts of the built
             library beside it, cuobjdump); a one-rank hvd.allreduce
             under set_compression("int8"), bitwise the plain
             reference_allreduce, within one step per phase of the exact
             sum, the residual carried to the next tick; GPT-2-small
             through the hook path under no policy, int8 and int4 (LN and
             biases uncompressed) from the same init and batches, 3 steps
             each: the first loss bitwise the uncompressed one, losses
             finite, falling and within 2% of the uncompressed; then
             timed in turns (none, int8, int8, none; 2 warm-up and 5
             timed steps): step ms, tokens/s, the two kernels' launches a
             step (2 per quantized bucket each, every quant_pack launch
             the one pass, asserted), quant_pack's calls by dtype, logical and
             wire bytes a step, each flash kernel 12 times a step, and
             one profiled int8 step: the two kernels' device time
             against the bytes the quantized path must move.
9. overlap - GPT-2-small as chained_lm_loss (embedding, 12 layer stages,
             head) through make_train_step(overlap=off|serial|on), on
             forced (auto is off on one card): 3 steps each from the
             same weights, on == serial == off bitwise in losses and
             parameters, and under an int8 policy (every bucket
             quantized: a name rule does not match a bucket's wire name)
             on == serial bitwise;
             then in turns (off, serial, on, on with
             HVD_TPU_DISABLE_NATIVE=1 twice, on, serial, off; 2 warm-up
             and 5 timed steps): step ms, buckets a step, one fused
             response a bucket (plus the loss's), no cache miss, each
             flash kernel 12 times a step, overlap.exposed_comm_seconds;
             one profiled on step (idle share, the executor's first work
             against the last dQ) and a cProfile of the host's step; one
             profiled int8 on step: where each quantized bucket's codec
             kernels start against the end of the last dQ (every
             quant_pack launch the one pass, asserted; its calls by
             dtype).
10. parallel - the multi-axis step (ROADMAP A.3, first half) at
             GPT-2-small's widths on a one-rank mesh (data x seq x model,
             every axis of size 1: one card has no second rank):
             make_parallel_train_step with ParallelAxes(data, seq, model),
             batch 8, seq 1024, AdamW(3e-4), 3 steps from the trainer's
             weights and batch: with HVD_TPU_FUSE=off losses and every
             weight bitwise the monolithic make_train_step's; with fusion
             on (the default, 4 chunks of 2,048 rows) reported bitwise or
             held within the bf16 allowance (first-step gradients) and
             AdamW's bound (weights); 12 launches of each flash kernel a
             step; remat=True within the reference's remat tolerance or
             bitwise, its peak memory beside the plain step's; parallel,
             monolithic, unfused parallel twice, monolithic, parallel
             timed in turns (2 warm-up, 5 timed steps: step ms and the
             host's enqueue ms a step) and one profiled parallel step.
             A ring of 4
             played in one process (parallel/sequence.py play_ring, the
             hop functions ring_attention runs) at b1 h12 s8192 d64 bf16,
             causal and non-causal: o, dq, dk, dv within the bf16
             allowance of flash attention over the whole sequence, 10 and
             16 launches of each kernel, the hops' kernel time (CUDA
             events around each launch) against the whole sequence's;
             Ulysses over one rank bitwise flash
             attention.  MoE (8 experts, top-2, capacity factor 2, the
             experts on the data axis, 12 layers, batch 2): 3 steps,
             losses finite and falling, aux > 0, dropped fractions, 12
             launches of each kernel a step; then 2 layers in f32, one
             forward and backward on the card against the CPU (loss
             1e-5, each gradient leaf 1e-4 of its largest magnitude),
             with the router's near-ties counted.
11. sharded - ZeRO-1 and FSDP (ROADMAP A.3, second half (a)) on one rank:
             GPT-2-small (the trainer's weights and batch) through
             make_train_step, make_zero_train_step and
             make_fsdp_train_step, AdamW(3e-4, the for-each form on
             every side), 3 steps each: losses and weights bitwise the
             monolithic step's, or within AdamW's bound (the row says
             which held); 12 launches of each flash kernel a step on
             both sharded paths.  The flat update as 4 shards, each with
             its own AdamW, against one: GPT-2-small's weights and a
             3-element leaf (not a multiple of 4), 3 steps of seeded
             gradients, bitwise, the padding left zero.  Then in turns
             (monolithic, zero, fsdp, fsdp, zero, monolithic; 2 warm-up
             and 5 timed steps): step ms, the host's enqueue ms, the
             memory held between steps and the peak during them, the
             optimizer-state bytes the rank holds; one profiled ZeRO and
             one FSDP step.  ResNet-50 at bench.py's recipe through
             Trainer, Trainer(zero=True) and Trainer(fsdp=True) with
             BroadcastGlobalVariablesCallback, 3 steps on one batch
             (cuDNN's deterministic algorithms): bitwise, or each leaf's
             update within RESNET_TOL_UPDATE (the row says which held).
             One rank moves no byte and saves no memory: the phase
             shows the path's arithmetic and costs, not a gain.
12. pipeline - pipeline parallelism (ROADMAP A.3, second half (b)) on
             one rank: GPT-2-small as chained_lm_loss (embedding, 12 layer
             stages, head: 14 stages), the trainer's weights and batch, 8
             microbatches of one sequence, through
             make_pipeline_train_step under gpipe, 1f1b and 1f1b with
             interleave 2, AdamW(3e-4, foreach), 3 steps each: losses and
             every weight bitwise across the three; the first loss within
             1e-5 relative of make_train_step's, the first step's
             gradients within PIPE_GRAD_ALLOWANCE x the bf16 allowance,
             the weights after 3 steps within AdamW's bound; 192 / 96 / 96
             launches of the flash forward / dK/dV / dQ a step (each
             stage's backward recomputes its forward), by the counters and
             in one profiled 1f1b step (all sm90 forms).  In turns
             (monolithic, gpipe, 1f1b, 1f1b v2, 1f1b, gpipe, monolithic;
             2 warm-up and 5 timed steps): step ms, tokens/s, enqueue ms,
             pipeline.bubble_seconds, memory held and peak, the peak
             carries and their bytes against the plan's.  The three
             kernels at b1 h12 s1024 against their bound.  gpipe through
             ParallelAxes(data, pipe) at a pipe axis of one, 2
             microbatches, 3 steps of make_parallel_train_step against
             the monolithic step; a pipeline of 4 stages of 3 layers
             played in one process (pipeline.play_gpipe) against the 12
             layers in sequence.  One card is one rank: the schedules
             cannot differ in speed; the phase shows the arithmetic and
             the costs (recompute, launches, host dispatch).
13. checkpoint - checkpoint and resume (utils/checkpoint.py): GPT-2-small
             (the trainer's configuration, AdamW(3e-4, foreach), seed 0)
             through make_train_step, 6 straight steps against 3 steps,
             save_checkpoint({params, opt}, step=3) without block, a 4th
             step before wait(), the weights from seed 1 and a fresh AdamW
             restored, resume_epoch == 3 and 3 resumed steps: losses and
             weights bitwise; each flash kernel 12 times a resumed step
             (sm90 forms only, one more resumed step profiled); the
             checkpoint's bytes, save_checkpoint's call (the snapshot),
             checkpoint.write_seconds and its MB/s, wait(), the restore
             and its read / decode / copy to the card.  The run's tree
             saved with save_checkpoint_sharded at a virtual world of 4
             and restored into other weights, bitwise, both timed.  The
             step with a write in flight against none, in turns (6 each).
             The same resume through make_zero_train_step and
             make_fsdp_train_step (3 + 3 against 6) and the 14-stage 1f1b
             pipeline with its per-stage optimizers (1 + 1 against 2),
             bitwise.  The ResNet example: fit(--full, epochs=1) saving,
             then fit(epochs=2) resuming: the restored parameters and BN
             statistics bitwise the saved ones, the run starting at epoch
             1, the loss finite, everything on the card.  The files live
             under --out-dir/checkpoint_files for the phase only.
14. serving - GPT-2-small (seed-0 weights, bf16) served by the port's
             InferenceEngine on the card: 8 slots, page size 16, capacity
             1024 (513 pages, 302,579,712 B of K and V).  First why the
             kernels exist: rows of the five products (fused QKV, wo,
             w_in, w_out, the f32 logits) and of cache_attention at M (or
             s, b) in 2, 16, 37, 65, 127, 512, 1024 against the full run,
             for torch.matmul / the batched torch formula and for the
             port's serving_gemm and cache_attention (which must be
             invariant), and layer_norm, GELU and the residual add
             recorded.  Each kernel against its plain version at M 16 and
             1024 (f32 within 1e-5 of each row's RMS, bf16 within the
             bf16 allowance) and the attention at decode (b8 s2, an
             inactive slot) and prefill (b1 s1024), two runs bitwise, the
             form each takes by the counters (bf16: the Hopper form; f32:
             the first), timed beside the bound, the library call
             (torch.matmul; SDPA in f32 with the same boolean mask) and,
             in turns, the first form's bf16 build, which the Hopper form
             must beat at the prefill shapes; then K and V views holding
             NaN past every row's position (finite output, within the
             allowance of the plain version on a zeroed copy) and the
             host time of a tensor-map encode.  The contract, bitwise: prompts
             of 7, 300 and 1000 tokens (the last decoding to the capacity
             boundary) prefilled and decoded row for row equal to
             serving_forward at capacity 1024; a ragged batch of 8 equal
             to each sequence alone; the greedy rollout equal to the
             argmax of serving_forward token by token; a 512-token
             prefix-cache hit equal to the cold prefill with fewer
             prefill tokens; speculative decoding (3 tokens) equal to
             plain decode with a 2-layer agreement draft (acceptance 1.0)
             and an uncorrelated 2-layer full-width draft.  bench.py's
             trace (seed 7, 40 requests) through continuous and static
             batching: identical tokens; tokens/s, iterations, TTFT and
             per-token p50/p99, decode-iteration and prefill ms by
             bucket, one profiled decode iteration (idle share); 8
             prompts of 512-1000 tokens (the 1024 bucket).  LMServer on
             127.0.0.1 port 0: /healthz NOT_READY then READY, 4
             concurrent /generate answers equal to engine.generate, a
             client that disconnects frees its slot.  A serving
             checkpoint saved, loaded and served to the same tokens.  No
             flash kernel launches in the phase, and the continuous leg
             launches only the serving kernels' Hopper forms.
15. serving_mp - the rest of serving (ROADMAP A.4).  Rank 0 and a
             follower as two engines in one process (one card, and NCCL
             puts no two ranks on one device), the leader's broadcasts
             pickled through a queue: bench.py's trace (seed 7, 40
             requests) on the leader, the follower calling follow()
             after every step(); after each iteration the follower's
             K and V pages (all but the trash page 0, which duplicate
             writes leave to the device's choice), page table, lengths
             and live slots' tokens bitwise the leader's; again with
             speculative decoding (3 tokens, a 2-layer draft); abort_all
             mid-stream frees every slot on both sides; stop_followers
             ends follow(); the two sides' ms an iteration.  The serving
             kernels at one rank's shapes on a model axis of 2 and 4
             (column-parallel QKV and FFN-in, bf16 out; row-parallel wo
             and FFN-out with f32 partials; the attention at 6 and 3
             heads): the Hopper form by the counters, within the
             allowance of the plain version at M 16 and 1024, two runs
             bitwise, row-invariant at every M of SERVING_ROWS, timed
             beside the bound and torch.matmul.  A mesh engine at model
             axis 1 bitwise the plain engine (tokens and logits); an
             axis of 2 played in one process (each shard's partials on
             the card, summed by the closers' ordered_sum): prefill +
             decode bitwise the played serving_forward at 7 and 300
             tokens, the logits within twice the single-device bf16
             engine's own distance from the f32 forward (per row RMS),
             the greedy agreement with the single device reported.
16. distill - examples/distill_draft.py: GPT-2-small's serving
             checkpoint exported and loaded, the half-size draft (d 384,
             6 heads, 6 layers, d_ff 1536) distilled 20 steps at batch 8,
             seq 1024 (loss finite and falling; the backward kernels 6
             times a step over the 20 steps, each flash kernel 6 times
             in each of 6 more timed steps of distill's own train step,
             the sm90 forms only in one profiled step), exported,
             loaded as serve_lm --draft does,
             and served: the speculative tokens (3 a step) bitwise plain
             decode's; the held-out agreement and the acceptance rate.
             Telemetry checks ride other phases: eager (the hook step
             with the flight recorder on and off in turns, a seeded
             stall's dump naming the tensor, seeded on a second native
             coordinator beside the runtime's, the cache's flush and
             downgrade records, cluster_metrics at one rank, init()
             serving /metrics on HVD_TPU_METRICS_PORT and shutdown()
             closing it), parallel (measure_exposed_comm on the fused
             closer, observed in fused.exposed_comm_seconds), pipeline
             (the pipeline.* series moved by exactly each step's
             stats()), resnet (MetricsLogger's values in every epoch's
             logs of the --full flow).
17. observe - the analysis, trace and memory tooling (ROADMAP A.5.2) at
             GPT-2-small's width.  (a) 3 hook-driven AdamW steps (bf16,
             batch 8, seq 1024) in a child process under
             HVD_TPU_LOCK_CHECK=1, HVD_TPU_RACE_CHECK=1,
             HVD_TPU_VERIFY_PROGRAM=1 and the tracer, bitwise the same 3
             steps here with all of them off (losses, weights, AdamW's
             moments); each flash kernel 12 times a step (and the sm90
             forms in the child's profiled step); verify_program's
             report (18 signatures a step), the race checker's count, the
             step's trace.analyze decomposition; the hook step with the
             tracer on and off in turns (5 pairs).  (b) bench.py's trace
             (seed 7, 40 requests) served with the tracer on and off in
             turns (5 pairs): identical tokens, one serving.iteration
             span per iteration that ran work, the decode iteration's
             p50.  (c) plan_serving (8 slots, 64 pages of 16, bf16) equal
             to the engine's K and V pools and the ledger's
             serving.kv_pages (302,579,712 B); the --prefix-pages 64 and
             --draft-layers 6 what-ifs beside a draft engine's cache
             (distill_draft.draft_config, d 384); plan_transformer_lm at
             f32 and adam: the parameter bytes (544,548,864) and AdamW's
             moments equal to the port's tensors exactly, the plan's
             total beside the allocator's peak over one step, the
             ledger's categories.  (d) HVD_TPU_MEM_CAPACITY just under
             the ledger's total: a serving decode raises
             ResourceExhaustedError through guard, its flight dump naming
             serving/decode and the top categories; an allocation larger
             than the card inside guard("oom_probe"): the same
             torch.cuda.OutOfMemoryError re-raised, its dump holding the
             allocator's figures and a live-tensor sweep between the
             engine's known bytes and memory_allocated; then one more
             training step.  (e) python -m horovod_tpu_torch.analysis
             --strict over the package, as a subprocess, exits 0.
18. elastic - elastic training and serving (ROADMAP A.5.3).
             (a) GPT-2-small (bf16, batch 8, seq 1024, AdamW) through
             Trainer, TrainerState and @elastic.run, as a child of
             python -m horovod_tpu_torch.run --elastic -np 1 (this file
             with --elastic-child), 8 steps with a commit every 2:
             uninterrupted; killed hard (os._exit) before step 5 once
             its step-4 commit is durable, relaunched once by the
             launcher, resumed from step 4; a HorovodError after step 5
             rolled back, reset and retried in process; killed again
             under HVD_TPU_FAULTS=ckpt.oserror:count=2@7.  Each run's
             final parameters and AdamW state bitwise the
             uninterrupted run's; each flash kernel 12 times a step in
             each incarnation.  (b) bench.py's trace (seed 7, 40
             requests) drained by ServingState.drain_commit at
             iteration 20; a fresh process syncs the commit on a fresh
             engine and finishes it; an LMServer drained mid-flight by
             POST /drain (its handlers answer 503), the payload POSTed
             to /resume of a fresh server in that process; every
             completion bitwise the uninterrupted rollout, the serving
             kernels launched in both incarnations.  Prints a commit's
             host-snapshot ms and bytes, its publish time and MB/s,
             death to relaunch, relaunch to the first resumed step
             (process start and init, restore and sync, the step), the
             retry's rollback and sync, drain_commit ms and blob bytes,
             the serving sync ms and the resumed requests' TTFT.
19. control - the TCP control channel (ROADMAP A.5 item 4 with A.2 item
             8), host code whose multi-rank legs run as CPU ranks on the
             card's machine (one card is one NCCL rank, and one rank
             has no exchange); the channel launches no kernel.  (a)
             python -m
             horovod_tpu_torch.chaos --matrix, every scenario: the local
             ones on the card (the router's two among them: a replica
             drained and killed behind the Router, the RouterServer's
             process SIGKILLed mid-generation), the cp fleets (the ten
             TCP scenarios among them) on the CPU, each one's verdict
             and seconds.
             (b) GPT-2-small at full width in f32 (vocab 32768, d 768,
             12 heads, d_ff 3072; cut: 2 layers, batch 1 of 128 tokens
             a rank, the ranks on the CPU, one thread each, 6 AdamW
             steps) through the hook-driven DistributedOptimizer under
             python -m horovod_tpu_torch.run -np 2 (this file with
             --control-child), with no fault and under
             HVD_TPU_FAULTS=transport.reset:count=1:after=<n>:rank=1@41,
             n (the frames rank 1 sent by the end of step 3 of the
             fault-free run) landing the reset after step 2 (checked):
             both ranks' parameters and
             AdamW state bitwise (sha256), "session resumed" shown and
             rank 1's transport.reconnects 1.  (c) the same at -np 3
             (HOROVOD_FUSION_THRESHOLD=0, so each tensor is summed alone
             and the sums' order is fixed), flat, under HVD_TPU_TREE=on
             HVD_TPU_TREE_FANOUT=1, and the tree under a reset of the
             leaf (rank 2): the tree runs bitwise the flat run, rank 0
             gathering expected_root_frames(3, 1) frames a cycle (2
             flat).  (d) tools/control_ab.py on this tree, one round
             beside (b) and (c)'s faulted runs: the median negotiated 4
             B allreduce at np 2 and np 3, a hard kill to its grace
             diagnosis (HVD_TPU_RECONNECT_GRACE=1.5), a reset to
             "session resumed" (the A/B against another checkout in
             turns is the tool's --trees A,B).  Every process of (a)-(d)
             zeroes the kernel launch counters before its work and
             reports them; the kernels line's "control" count is their
             sum (the matrix's serving scenarios on the card launch
             serving_gemm and cache_attention; the CPU ranks none).
20. tuning - closed-loop tuning (ROADMAP A.5 item 5: tuning/,
             utils/autotune.py, RETUNE markers on the cycle, live
             spec_tokens and prefix_pages).  (a) GPT-2-small (bf16,
             batch 8, seq 1024) through the hook-driven
             DistributedOptimizer under HOROVOD_AUTOTUNE=1 and
             HVD_TPU_TUNE=1 (0.5 s samples, one warm-up sample, the log
             in the out dir as autotune.csv) until autotuner.done: the 15
             (threshold, cycle) candidates and the commit applied as
             RETUNE markers in stream order, the committed pair in the
             runtime and the coordinators, the CSV's 15 rows and commit
             line, the rule table off the two pinned knobs, losses and
             final weights bitwise an untuned run of as many steps, each
             flash kernel 12 times a step (sm90 in a profiled step);
             the hook step with the controller on and off in turns
             (on, off, off, on, twice; 10 timed steps each) and one
             window's sensor pass.  (b)
             GPT-2-small served (8 slots, page 16, capacity 1024) with an
             untrained draft at distill_draft's shape, 48 requests of
             900-1000 tokens sharing a 64-token header, HVD_TPU_TUNE=1,
             an 8-cycle window, one negotiated 4 B allreduce after each
             engine iteration (a process serves without negotiated
             collectives; the controller ticks on the cycle): the live
             sensors' policy shrinks spec_tokens and grows prefix_pages
             through markers, the depth changes only between iterations,
             the tokens bitwise the trace with HVD_TPU_TUNE unset,
             serving_gemm and cache_attention in their Hopper forms.
             Prints the decisions and their reasons, each marker's
             cycles and ms from enqueue to apply, the sweep's scores,
             tuning.applied/decisions/vetoes/rollbacks, the turns' step
             ms, the phase's seconds and its kernel launches.
21. routing - the fleet router (ROADMAP A.5 item 6: routing/'s
             HttpReplicaClient, Router, FleetAutoscaler, RouterServer).
             GPT-2-small (bf16, one set of weights from --seed, default
             21) served by LMServer replicas (8 slots, page 16, capacity
             1024, the prefix cache on), each on a private route registry
             and port 0, behind a Router and a RouterServer with its poll
             thread, all in this process on the card; every answer's
             tokens held bitwise to one engine's completion computed
             beforehand outside the fleet.  (a) 48 seeded requests (6
             header families of 2-4 pages, 4-16-token suffixes, 16-32 new
             tokens) from 8 client threads through the router's
             /generate: bitwise, affinity hits > 0, both replicas
             serving; then the same prompts one at a time for one token,
             direct to the replica that served each and through the
             router in turns (direct, router, router, direct): the
             router-added p50/p99.  (b) A 256-token request
             drained mid-generation (drain_replica): the 503 partial
             continued on the survivor, merged bitwise; the export's
             chains donated to the survivor (its index grows by a header
             a client pinned to the victim warmed), a follow-up on that
             header routed there with affinity and one prefix-cache hit;
             the drained replica resumed.  (c) FleetAutoscaler (up_load 2,
             sustain 1, cooldown 0; price: the planner's KV and prefix
             bytes and the weights'; headroom: the card's free bytes):
             during a burst of 24 requests, veto:up while a tensor holds
             all but half the price of the card's free memory, then
             up:auto1 booting a third replica on the card, seeded from
             the donor before its first request, which routes to it with
             affinity; the burst bitwise; in the trough down:auto1, its
             chains donated.  (d) a replica's front door closed without a
             drain: ReplicaUnreachable, marked dead, the next dispatches
             on the survivor bitwise.  The serving kernels launched in
             every step in their Hopper form only, the flash kernels
             never (asserted, printed a step).  Prints the router-added
             latency, affinity hits, the drain-to-continuation time, the
             newcomer's seeded pages, the decisions and the phase's
             seconds.
22. word2vec - skip-gram word2vec with sparse embedding gradients
             (examples/word2vec.py) at upstream Horovod's
             tensorflow_word2vec.py configuration: vocabulary 50,000,
             embedding 128, batch 128, 64 negatives, window 2, a seeded
             Zipf corpus of 1,000,000 tokens, 200 steps on the card; the
             loss must fall and every tensor stay on the card; one step
             on the card against the same step on the CPU from the same
             weights and batch (1e-5 relative); steps/s, pairs/s, the
             sparse bytes a step against the dense table's 25.6 MB, and
             one profiled step (idle share).
23. resnet - ResNet data parallelism, which runs no kernel of the port's
             own (convolutions and batch norm are cuDNN/ATen): one
             ResNet18Thin train step (f32, TF32 off) on the card against
             the same step on the CPU; the --full example flow (ResNet-50,
             224 px, batch 32) through Trainer.fit with the four callbacks
             and prefetch, checking the LR/momentum sequence, the moved
             BN statistics and that everything ran on the card; then
             bench.py's recipe (ResNet-50, space-to-depth stem, 224 px,
             batch 128, bf16, SGD(0.1, 0.9)), 3 warm-up and 20 timed
             steps, images/s, TFLOP/s and one profiled step (idle share,
             top kernels); then ResNet-50 overlapped: the same recipe
             through make_train_step_with_state under overlap off,
             serial and on (deterministic cuDNN), 3 steps bitwise across
             the three, one response a bucket and no cache miss after
             the first step, no flash launch, everything on the card;
             step ms in turns (2 warm-up and 5 timed steps a turn),
             buckets a step, exposed communication and the leg's
             seconds (resnet_overlap_leg).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
horovod_tpu_torch package beside this file, it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import faulthandler
import functools
import gc
import itertools
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "long", "trainer", "gpt3_large",
          "eager", "quant", "overlap", "parallel", "sharded", "pipeline",
          "checkpoint",
          "serving", "serving_mp", "distill", "observe", "elastic",
          "control", "tuning", "routing", "word2vec", "resnet")

# Published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# Tolerances of kernel against plain version, element by element.
# f32: |kernel - plain| <= 5e-5 forward, 1e-4 backward, the reference's
# own (tests/test_flash_attention.py).  lse is f32 arithmetic in every
# dtype (bf16 products are exact in f32), so it takes the f32 forward
# tolerance too.  bf16 outputs (o, dq, dk, dv):
#     |kernel - plain| <= RTOL_BF16 * |plain| + ATOL_BF16 * rms(row of plain)
#                         + ATOL_FLOOR_BF16 * rms(all of plain)
# where a row is one query's (o, dq) or one key's (dk, dv) head_dim
# values.  The plain version runs in f32 from the same bf16 inputs and
# rounds its outputs to bf16; the kernel rounds p to bf16 before p.v and
# p^T.dO, ds before ds.k and ds^T.q, and its outputs to bf16, as the TPU
# kernels do.  Two roundings of one value to bf16 differ by at most one
# ulp, <= 2^-7 relative: RTOL_BF16.  Each p or ds rounding is a relative
# 2^-9 error on one term of a row's sum, so the sum is off by about
# 2^-9 times the row's own size, and the largest of millions of such
# errors by a few times that: ATOL_BF16 = 2^-5 of the row's RMS leaves a
# margin of a few.  Tolerances relative to each row, not to the largest
# element, so that the small late rows of a causal output (o_i ~ 1/sqrt(i))
# are held as tightly as the large early ones.  A row that is exactly
# zero in the plain version (dq of a query that sees one key) is not
# exactly zero after delta = rowsum(dO * O) is rounded, so the allowance
# has a floor of 2^-9 of the RMS of the whole output.
TOL_F32_FWD, TOL_F32_BWD = 5e-5, 1e-4
RTOL_BF16, ATOL_BF16, ATOL_FLOOR_BF16 = 2.0 ** -7, 2.0 ** -5, 2.0 ** -9

# The library yardstick's backend (torch.nn.attention.SDPBackend member);
# its flash backend takes no f32, so f32 cases pin the memory-efficient one.
SDP_BACKEND_NAME = "FLASH_ATTENTION"
SDP_BACKEND_F32_NAME = "EFFICIENT_ATTENTION"

# Kernel-name substrings that sort a profiled step's device time by kind
# (a kernel matching none is in no kind; the kinds may overlap).
KERNEL_KINDS = {
    "nccl": ("nccl",),
    "conv_gemm": ("conv", "xmma", "gemm", "cudnn", "nvjet", "cutlass"),
    "batch_norm": ("batch_norm", "batchnorm", "bn_"),
    "elementwise": ("elementwise", "vectorized"),
    "reduce": ("reduce",),
}

# resnet phase, card against CPU (f32 compute, TF32 off): the card's
# convolution algorithms sum in another order than the CPU's (and may be
# Winograd or FFT), so each value differs by float rounding, carried
# through 17 layers and their batch norms.  Bound, relative to the
# largest magnitude of the value or leaf compared:
RESNET_TOL_LOSS = 1e-5     # the loss
RESNET_TOL_STATE = 1e-5    # each new BN statistic leaf
# Each parameter leaf's update p1 - p0 (both sides start from the same
# p0, so this holds the parameters too; a zero-initialised BN scale is
# all update).  The update is lr * grad plus weight decay; a gradient is
# a sum over the batch and the pixels, and the batch norm's backward
# subtracts two such sums that nearly cancel, so it keeps fewer correct
# digits than the forward values.
RESNET_TOL_UPDATE = 1e-3


LOG_FILE = None  # every line also goes to <out-dir>/chip_smoke.log
PROFILE_PAD_S = 0.25  # idle card before and after a profiled step


def log(obj) -> None:
    line = obj if isinstance(obj, str) else json.dumps(obj)
    print(line, flush=True)
    if LOG_FILE is not None:
        with open(LOG_FILE, "a") as f:
            f.write(line + "\n")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3,
                 queued: bool = False) -> float:
    """Mean device time of fn() over iters launches, by CUDA events.
    ``queued``: the launches are queued behind ~30 ms of spinning on the
    card, so the device runs them back to back; without it a launch
    shorter than the host's enqueue of the next is timed at the host's
    pace."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(q_len, kv_len, causal, q_offset) -> int:
    """(query, key) pairs the mask lets through: the work these inputs
    need, not the most they could."""
    if not causal:
        return q_len * kv_len
    rows = np.clip(np.arange(q_len) + q_offset + 1, 0, kv_len)
    return int(rows.sum())


def bound(flops: float, nbytes: float, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bf16_allowed(want):
    """Per-element tolerance of a bf16 output (see RTOL_BF16 above)."""
    rms_row = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    rms_all = want.pow(2).mean().sqrt()
    return (ATOL_BF16 * rms_row + ATOL_FLOOR_BF16 * rms_all
            + RTOL_BF16 * want.abs())


def check(name, got, want, allowed):
    """Holds got against want element by element: entries where want is
    not finite (the -inf lse of masked rows) must match it exactly, every
    other one must be within allowed(want).  Returns (max abs err, worst
    err / allowed), the second the margin left (must be <= 1)."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not bool(torch.equal(torch.isfinite(got), fin)) or not bool(
            torch.equal(got[~fin], want[~fin])):
        raise AssertionError(f"{name}: non-finite entries differ")
    err = torch.where(fin, (got - want).abs(), 0.0)
    tol = allowed(want)
    ratio = err / tol.clamp_min(torch.finfo(torch.float32).tiny)
    worst = float(ratio.max()) if ratio.numel() else 0.0
    if not worst <= 1.0:
        i = int(ratio.argmax())
        scale = float(want[fin].abs().max())
        raise AssertionError(
            f"{name}: element {i}: kernel {float(got.flatten()[i])} plain "
            f"{float(want.flatten()[i])} allowed {float(tol.flatten()[i])}; "
            f"max abs err {float(err.max())}, max |plain| {scale}")
    return (float(err.max()) if err.numel() else 0.0), worst


def kernel_case(fa, *, b, h, q_len, kv_len, d, causal, q_offset, dtype,
                seed, timing=False, queued=False):
    """One kernel-against-plain comparison on the card.  Returns
    {kernel: {max_abs_err, worst_ratio, ...timings}}; worst_ratio is the
    largest error over its allowance, so at most 1.  ``queued``: times
    as :func:`cuda_time_ms` with ``queued``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(s):
        return torch.randn(b * h, s, d, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    q, k, v, g = rnd(q_len), rnd(kv_len), rnd(kv_len), rnd(q_len)
    scale = d ** -0.5
    args = dict(sm_scale=scale, causal=causal, q_block_offset=q_offset)
    o, lse = fa.flash_fwd(q, k, v, scale, causal, q_offset)
    o_ref, lse_ref = fa._dense_forward(q, k, v, scale, causal, q_offset)
    torch.cuda.synchronize()

    def const(tol):
        return lambda want: torch.full_like(want, tol)

    def tol_out(tol_f32):
        return const(tol_f32) if dtype == torch.float32 else bf16_allowed

    errs = {"o": check("o", o, o_ref, tol_out(TOL_F32_FWD)),
            "lse": check("lse", lse, lse_ref, const(TOL_F32_FWD))}

    # Backward: each kernel against the plain backward on the same inputs,
    # the kernel forward's lse and delta = rowsum(dO * O) of its o.
    delta = torch.sum(g.float() * o.float(), dim=-1)
    bwd = (q, k, v, g, lse, delta, scale, causal, q_offset)
    dk, dv = fa.flash_bwd_dkdv(*bwd)
    dq = fa.flash_bwd_dq(*bwd)
    dq_ref, dk_ref, dv_ref = fa._dense_backward_from_delta(
        q, k, v, g, lse, delta, **args)
    torch.cuda.synchronize()
    for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv, dv_ref)):
        errs[name] = check(name, got, want, tol_out(TOL_F32_BWD))

    # The autograd Function on the card runs the same kernels on the same
    # inputs, so its gradients equal the direct calls bitwise.  In f32 they
    # are also held against autograd through the plain forward at the
    # reference's 1e-4 (rows that see no key are left to the check above:
    # the plain forward's masked exp has no gradient there).  Not in bf16:
    # autograd through the plain forward takes delta from the unrounded
    # f32 o, the kernels' contract (the TPU kernels' too) from the bf16 o,
    # and in rows where dp ~ delta that difference, not the kernels, sets
    # the error.
    q4, k4, v4 = (t.view(b, h, -1, d).detach().requires_grad_(True)
                  for t in (q, k, v))
    o4 = fa.flash_attention(q4, k4, v4, causal=causal, sm_scale=scale,
                            q_block_offset=q_offset)
    grads = torch.autograd.grad(o4, (q4, k4, v4), g.view(b, h, -1, d))
    for name, got, want in zip(("dq", "dk", "dv"), grads, (dq, dk, dv)):
        if not bool(torch.equal(got.reshape(want.shape), want)):
            raise AssertionError(f"autograd {name} differs from the kernel's")
    if dtype == torch.float32 and not bool(torch.isneginf(lse_ref).any()):
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        o_plain, _ = fa._dense_forward(qr, kr, vr, scale, causal, q_offset)
        for name, got, want in zip(
                ("dq", "dk", "dv"), (dq, dk, dv),
                torch.autograd.grad(o_plain, (qr, kr, vr), g)):
            check(f"autograd {name}", got, want, const(TOL_F32_BWD))

    def result(*names):
        return {"max_abs_err": max(errs[n][0] for n in names),
                "worst_ratio": max(errs[n][1] for n in names)}

    out = {"flash_fwd": result("o", "lse"),
           "flash_bwd_dkdv": result("dk", "dv"),
           "flash_bwd_dq": result("dq")}
    if not timing:
        return out

    bh, el = b * h, torch.tensor([], dtype=dtype).element_size()
    pairs = visible_pairs(q_len, kv_len, causal, q_offset) * bh
    q_bytes, kv_bytes, row_bytes = bh * q_len * d * el, bh * kv_len * d * el, \
        bh * q_len * 4
    work = {  # (flops, bytes): products of the kernel, inputs read once,
        #       outputs written once
        "flash_fwd": (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        "flash_bwd_dkdv": (8 * d * pairs,
                           2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
        "flash_bwd_dq": (6 * d * pairs,
                         3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
    }
    kernel_fns = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, scale, causal, q_offset),
        "flash_bwd_dkdv": lambda: fa.flash_bwd_dkdv(*bwd),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(*bwd),
    }
    plain_fns = {
        "flash_fwd": lambda: fa._dense_forward(q, k, v, scale, causal,
                                               q_offset),
        "flash_bwd_dkdv": lambda: fa._dense_backward_from_delta(
            q, k, v, g, lse, delta, **args),
        "flash_bwd_dq": lambda: fa._dense_backward_from_delta(
            q, k, v, g, lse, delta, **args),
    }
    # Yardstick: torch's fused attention on the same inputs, forward, and
    # backward (one call computes dq, dk and dv together), pinned to one
    # backend so that the number means the same thing from run to run.
    from torch.nn.attention import SDPBackend, sdpa_kernel
    f = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, g4 = (t.view(b, h, -1, d) for t in (q, k, v, g))
    lib = {"flash_fwd": None, "bwd": None}
    backend = (SDP_BACKEND_F32_NAME if dtype == torch.float32
               else SDP_BACKEND_NAME)
    if q_len == kv_len and q_offset == 0:
        with sdpa_kernel(getattr(SDPBackend, backend)):
            lib["flash_fwd"] = cuda_time_ms(
                lambda: f(q4, k4, v4, is_causal=causal), queued=queued)
            ql, kl, vl = (t.detach().requires_grad_(True)
                          for t in (q4, k4, v4))
            o_lib = f(ql, kl, vl, is_causal=causal)
        lib["bwd"] = cuda_time_ms(lambda: torch.autograd.grad(
            o_lib, (ql, kl, vl), g4, retain_graph=True), queued=queued)
    for name, (flops, nbytes) in work.items():
        launches_before = dict(fa.launches)
        out[name]["ms"] = cuda_time_ms(kernel_fns[name], queued=queued)
        fa.launches.update(launches_before)  # timing launches do not count
        out[name]["plain_ms"] = cuda_time_ms(plain_fns[name], iters=5,
                                             queued=queued)
        out[name]["bound_ms"], out[name]["bound_by"] = bound(flops, nbytes,
                                                             dtype)
        out[name]["library_ms"] = lib["flash_fwd" if name == "flash_fwd"
                                      else "bwd"]
    return out


def tensor_map_encode_us(fa, iters=1000) -> float:
    """Host microseconds to encode one TMA tensor map, as the redesigned
    kernels do three (forward) or four (dK/dV, dQ) times a launch."""
    from horovod_tpu_torch.ops import _build
    fn = _build.library("flash_fwd").hvd_flash_tensor_map_us
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_double
    buf = torch.empty(96 * 1024 * 64, dtype=torch.bfloat16, device="cuda")
    us = fn(buf.data_ptr(), iters)
    if not us > 0:
        raise AssertionError(f"tensor map encode failed ({us})")
    return us


def phase_kernels(fa):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main = kernel_case(fa, b=8, h=12, q_len=1024, kv_len=1024, d=64,
                       causal=True, q_offset=0, dtype=torch.bfloat16, seed=0,
                       timing=True)
    log({"phase": "kernels", "case": "main b8 h12 s1024 d64 causal bf16",
         "library": f"scaled_dot_product_attention, SDPBackend."
                    f"{SDP_BACKEND_NAME}", "result": main})
    us = tensor_map_encode_us(fa)
    log({"phase": "kernels", "tensor_map_encode_us": us,
         "encodes_per_trainer_step": 12 * (3 + 4 + 4),
         "host_ms_per_trainer_step": us * 12 * (3 + 4 + 4) / 1e3})
    cases = [
        ("f32 causal", dict(b=2, h=4, q_len=512, kv_len=512, d=64,
                            causal=True, q_offset=0, dtype=torch.float32)),
        ("bf16 non-causal", dict(b=2, h=4, q_len=512, kv_len=512, d=64,
                                 causal=False, q_offset=0,
                                 dtype=torch.bfloat16)),
        ("bf16 ragged 1000", dict(b=2, h=4, q_len=1000, kv_len=1000, d=64,
                                  causal=True, q_offset=0,
                                  dtype=torch.bfloat16)),
        ("bf16 ragged 1000 d128", dict(b=2, h=4, q_len=1000, kv_len=1000,
                                       d=128, causal=True, q_offset=0,
                                       dtype=torch.bfloat16)),
        ("bf16 ragged 200", dict(b=2, h=4, q_len=200, kv_len=200, d=64,
                                 causal=True, q_offset=0,
                                 dtype=torch.bfloat16)),
        ("bf16 ragged 200 d128", dict(b=2, h=4, q_len=200, kv_len=200,
                                      d=128, causal=True, q_offset=0,
                                      dtype=torch.bfloat16)),
        ("bf16 non-causal q300 kv1000", dict(b=2, h=4, q_len=300,
                                             kv_len=1000, d=64, causal=False,
                                             q_offset=0,
                                             dtype=torch.bfloat16)),
        ("bf16 non-causal q300 kv1000 d128", dict(b=2, h=4, q_len=300,
                                                  kv_len=1000, d=128,
                                                  causal=False, q_offset=0,
                                                  dtype=torch.bfloat16)),
        ("f32 ragged 1000 non-causal", dict(b=1, h=2, q_len=1000,
                                            kv_len=1000, d=32, causal=False,
                                            q_offset=0,
                                            dtype=torch.float32)),
        ("bf16 q256 kv1024 offset 768", dict(b=2, h=4, q_len=256,
                                             kv_len=1024, d=64, causal=True,
                                             q_offset=768,
                                             dtype=torch.bfloat16)),
        ("bf16 q256 kv1024 offset 700", dict(b=2, h=4, q_len=256,
                                             kv_len=1024, d=64, causal=True,
                                             q_offset=700,
                                             dtype=torch.bfloat16)),
        ("bf16 q256 kv1024 offset 700 d128", dict(b=2, h=4, q_len=256,
                                                  kv_len=1024, d=128,
                                                  causal=True, q_offset=700,
                                                  dtype=torch.bfloat16)),
        ("bf16 fully masked (offset -1000)", dict(
            b=1, h=2, q_len=128, kv_len=256, d=64, causal=True,
            q_offset=-1000, dtype=torch.bfloat16)),
        ("bf16 partly masked (offset -100)", dict(
            b=1, h=2, q_len=200, kv_len=256, d=64, causal=True,
            q_offset=-100, dtype=torch.bfloat16)),
        ("bf16 d128", dict(b=1, h=4, q_len=384, kv_len=384, d=128,
                           causal=True, q_offset=0, dtype=torch.bfloat16)),
        ("f32 d128", dict(b=1, h=2, q_len=160, kv_len=160, d=128,
                          causal=True, q_offset=0, dtype=torch.float32)),
        ("bf16 d16", dict(b=1, h=2, q_len=100, kv_len=300, d=16,
                          causal=False, q_offset=0, dtype=torch.bfloat16)),
    ]
    for i, (label, kw) in enumerate(cases):
        res = kernel_case(fa, seed=i + 1, **kw)
        log({"phase": "kernels", "case": label, "result": res})
    # The fully masked case's outputs are exact zeros, lse -inf.
    gen = torch.Generator(device="cuda").manual_seed(99)
    q = torch.randn(2, 64, 64, generator=gen, device="cuda").bfloat16()
    o, lse = fa.flash_fwd(q, q, q, 0.125, True, -1000)
    if not (bool((o == 0).all()) and bool(torch.isneginf(lse).all())):
        raise AssertionError("fully masked rows must give o = 0, lse = -inf")
    return main


def phase_long(fa):
    res = kernel_case(fa, b=1, h=12, q_len=8192, kv_len=8192, d=64,
                      causal=True, q_offset=0, dtype=torch.bfloat16, seed=7,
                      timing=True)
    log({"phase": "long", "case": "b1 h12 s8192 d64 causal bf16",
         "result": res})
    torch.cuda.empty_cache()


def profile_step(step, out_dir, prefix):
    """One more ``step()`` under torch.profiler, tracing the device only
    (host op tracing nearly doubles the step): device time by kernel (from
    the trace's kernel, memcpy and memset events), and the share of that
    step's own wall time, on the host clock from a synchronized start to
    a synchronized end, in which no kernel ran.  Writes
    ``<prefix>_trace.json`` and ``<prefix>_profile.txt``.

    The device records of the first milliseconds of a profiler session
    are dropped (launches with no kernel record; ~5 ms on an idle host,
    longer late in a long process), which emptied a 10 ms step's trace:
    the step starts PROFILE_PAD_S after the session does, on an idle
    card, and the session outlasts it by as much again.
    ``launches_unrecorded`` counts the step's launch records left without
    a device record."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        step()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(PROFILE_PAD_S)
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, f"{prefix}_trace.json")
    prof.export_chrome_trace(trace_path)
    with open(os.path.join(out_dir, f"{prefix}_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40))
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    recorded = {e.get("args", {}).get("correlation") for e in kernels}
    unrecorded = sum(
        1 for e in events if e.get("cat") == "cuda_runtime"
        and re.search(r"Launch|Memcpy|Memset", e.get("name", ""))
        and e.get("args", {}).get("correlation") not in recorded)
    if not kernels:
        raise AssertionError(f"the profiler recorded no device activity "
                             f"({unrecorded} launch records without one)")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:  # union of kernel intervals (streams may overlap)
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in kernels:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"device_busy_ms": busy_us / 1e3, "device_events": len(kernels),
            "launches_unrecorded": unrecorded, "enqueue_ms": enqueue_ms,
            "device_span_ms": (spans[-1][1] - spans[0][0]) / 1e3,
            "profiled_step_ms": wall_us / 1e3,
            "device_idle_share": 1 - busy_us / wall_us,
            "flash_kernels_ms": sum(ms for name, (ms, _) in top
                                    if "hvdflash" in name),
            "flash_kernels": {name.split("(")[0]: n for name, (_, n) in top
                              if "hvdflash" in name},
            "by_kind_ms": {kind: sum(ms for name, (ms, _) in top
                                     if any(w in name.lower() for w in words))
                           for kind, words in KERNEL_KINDS.items()},
            "top": [{"kernel": name[:90], "ms": ms, "calls": n}
                    for name, (ms, n) in top[:12]]}


def train_and_profile(fa, cfg, *, model, batch, seq, warmup, steps,
                      smi_line, out_dir, phase):
    """``cfg`` trained through ``transformer_lm.train`` (the monolithic
    step) for ``warmup + steps`` steps on the card, then one more step
    profiled: the loss finite and falling, each flash kernel launched
    n_layers times a step by the counters, all on its Hopper form at the
    model's head_dim, and only the Hopper forms' kernels, each n_layers
    times, in the profiled step.  Logs ``{"phase": phase}`` and
    ``{"phase": phase + "_profile"}``; returns the launches at that
    (form, head_dim) and the run (its step, parameters and batch)."""
    from horovod_tpu_torch.examples import transformer_lm

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    run = transformer_lm.train(cfg, batch=batch, seq=seq,
                               steps=warmup + steps, timed_from=warmup,
                               device="cuda", seed=0)
    head_dim = cfg.d_model // cfg.n_heads
    by_form = dict(fa.launches_by_form)
    launches = {name: by_form.get((name, "sm90", head_dim), 0)
                for name in fa.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = run["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    per_step = {n: c / (warmup + steps) for n, c in launches.items()}
    if any(c != cfg.n_layers * (warmup + steps) for c in launches.values()) \
            or sum(by_form.values()) != sum(launches.values()):
        raise AssertionError(
            f"each kernel must launch n_layers={cfg.n_layers} times a "
            f"step, on its sm90 form at head_dim {head_dim}; launches over "
            f"{warmup + steps} steps by (kernel, form, head_dim): {by_form}")
    step_ms = run["timed_seconds"] / steps * 1e3
    log({"phase": phase, "model": model, "params": run["n_params"],
         "batch": batch, "seq": seq, "head_dim": head_dim,
         "dtype": "bfloat16", "losses": losses, "step_ms": step_ms,
         "tokens_per_s": batch * seq * steps / run["timed_seconds"],
         "launches_per_step": per_step, "device": smi_line,
         "peak_mem_gb": peak_gb})
    prof = profile_step(lambda: run["step"](run["params"], run["data"]),
                        out_dir, phase)
    log({"phase": f"{phase}_profile", **prof})
    # No fallback: bf16 at head_dim 64 to 128 runs the three redesigned
    # kernels, each once a layer, never the first form's kernels of the
    # same names.
    names = " ".join(prof["flash_kernels"])
    for want in ("flash_fwd_sm90_kernel", "flash_bwd_dkdv_sm90_kernel",
                 "flash_bwd_dq_sm90_kernel"):
        ran = sum(n for name, n in prof["flash_kernels"].items()
                  if want in name)
        if ran != cfg.n_layers:
            raise AssertionError(f"the profiled step ran {want} {ran} times, "
                                 f"not {cfg.n_layers}: {names}")
    for first_form in ("flash_fwd_kernel<", "flash_bwd_dkdv_kernel<",
                       "flash_bwd_dq_kernel<"):
        if first_form in names:
            raise AssertionError(f"the profiled step ran {first_form}: "
                                 f"{names}")
    return launches, run


def phase_trainer(fa, smi_line, out_dir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import transformer_lm

    launches, _ = train_and_profile(
        fa, transformer_lm.bench_config(), model="GPT-2-small", batch=8,
        seq=1024, warmup=2, steps=5, smi_line=smi_line, out_dir=out_dir,
        phase="trainer")
    hvd.shutdown()
    return launches


# GPT-3 Large (Brown et al. 2020, "Language Models are Few-Shot Learners",
# Table 2.1): d_model 1536, 16 heads of 96, 24 layers, n_ctx 2048, d_ff 4
# d_model, in the repo's GPT-2-style blocks (pre-LN, learned positions,
# tanh GELU, untied unembedding) over GPT-2's vocabulary of 50257, bf16:
# 837,347,328 parameters (the paper's 760M counts one tied embedding).
# No cut: every layer, width and the full context.
GPT3_LARGE_PARAMS = 837_347_328


def gpt3_large_config():
    from horovod_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(vocab_size=50257, d_model=1536, n_heads=16,
                             n_layers=24, d_ff=6144, max_seq_len=2048,
                             dtype=torch.bfloat16)


# The flash kernels at the partial second panel, (label, kernel_case
# arguments, timed): GPT-3 Large's training shape; GPT-3 2.7B's attention
# (32 heads of 80, Table 2.1); f32 at d96 (the first form); the streamed
# rows (kv > 4096: rows 2, 5, 6 of PERF.md's table) at d96; then untimed
# ragged, offset and masked edges.
GPT3_FLASH_CASES = (
    ("gpt3_large b4 h16 s2048 d96 causal bf16",
     dict(b=4, h=16, q_len=2048, kv_len=2048, d=96, causal=True, q_offset=0,
          dtype=torch.bfloat16), True),
    ("gpt3_2.7b b1 h32 s2048 d80 causal bf16",
     dict(b=1, h=32, q_len=2048, kv_len=2048, d=80, causal=True, q_offset=0,
          dtype=torch.bfloat16), True),
    ("f32 b1 h4 s1024 d96 causal (first form)",
     dict(b=1, h=4, q_len=1024, kv_len=1024, d=96, causal=True, q_offset=0,
          dtype=torch.float32), True),
    ("streamed b1 h16 s8192 d96 causal bf16",
     dict(b=1, h=16, q_len=8192, kv_len=8192, d=96, causal=True, q_offset=0,
          dtype=torch.bfloat16), True),
    ("bf16 ragged 1000 d96",
     dict(b=2, h=4, q_len=1000, kv_len=1000, d=96, causal=True, q_offset=0,
          dtype=torch.bfloat16), False),
    ("bf16 non-causal q300 kv1000 d80",
     dict(b=2, h=4, q_len=300, kv_len=1000, d=80, causal=False, q_offset=0,
          dtype=torch.bfloat16), False),
    ("bf16 q256 kv1024 offset 700 d96",
     dict(b=2, h=4, q_len=256, kv_len=1024, d=96, causal=True, q_offset=700,
          dtype=torch.bfloat16), False),
    ("bf16 partly masked (offset -100) d80",
     dict(b=1, h=2, q_len=200, kv_len=256, d=80, causal=True, q_offset=-100,
          dtype=torch.bfloat16), False),
    ("f32 ragged 200 non-causal d80",
     dict(b=1, h=2, q_len=200, kv_len=200, d=80, causal=False, q_offset=0,
          dtype=torch.float32), False),
)
GPT3_CAPACITY = 2048


def logits_gemm_case(S, g, M, K, N):
    """``serving_gemm``'s f32 logits product ``x [M, K] @ w [K, N]`` against
    its plain version (1e-5 of each row's RMS), two runs bitwise, in the
    form ``serving_gemm_form`` gives it (at vocab 50257, not a multiple
    of 8: the first form), timed beside the bound, the plain version and
    ``torch.matmul`` of f32 copies (made once, off the clock)."""
    x = torch.randn(M, K, generator=g).cuda().bfloat16()
    w = (torch.randn(K, N, generator=g) * K ** -0.5).cuda().bfloat16()
    form = S.serving_gemm_form(torch.bfloat16, K, N)[0]
    S.reset_launches()
    got = S.serving_gemm(x, w, out_dtype=torch.float32)
    again = S.serving_gemm(x, w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    if S.launches_by_form[("serving_gemm", form)] != 2:
        raise AssertionError(f"serving_gemm logits M{M}: launches by form "
                             f"{S.launches_by_form}")
    if not torch.equal(got, again):
        raise AssertionError(f"serving_gemm logits M{M}: two runs differ")
    err, margin = check(f"serving_gemm logits M{M} N{N}", got,
                        S.serving_gemm_plain(x, w, torch.float32),
                        _row_rms_allowed(SERVING_TOL_F32))
    b_ms, b_by = bound(2.0 * M * N * K, (M * K + K * N) * 2 + M * N * 4,
                       torch.bfloat16)
    xf, wf = x.float(), w.float()
    return {"form": form,
            "ms": cuda_time_ms(lambda: S.serving_gemm(
                x, w, out_dtype=torch.float32), iters=20, queued=True),
            "plain_ms": cuda_time_ms(lambda: S.serving_gemm_plain(
                x, w, torch.float32), iters=3, warmup=1),
            "library_ms": cuda_time_ms(lambda: torch.matmul(xf, wf),
                                       iters=20, queued=True),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "worst_over_allowed": margin}


def gpt3_large_serving(fa, cfg, params, smi_line):
    """GPT-3 Large served by the port's engine (8 slots, page 16,
    capacity 2048) with the trained weights: prefill + decode bitwise
    serving_forward at 7, 300 and 2000 tokens (the last to the capacity
    boundary); 8 prompts of 64-1900 tokens (8-32 new tokens, seed 25)
    continuous and static, the same tokens; cache_attention on its Hopper
    form only, the logits product (vocab 50257) on serving_gemm's first
    form once a forward_step, no flash launch.  Returns the serving
    kernels' launches on the continuous leg and the contract's rows."""
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import serving as S
    from horovod_tpu_torch.serving import InferenceEngine, harness

    def engine_of():
        return InferenceEngine(params, cfg, device="cuda", max_slots=8,
                               page_size=16, capacity=GPT3_CAPACITY)

    def forward(tokens):
        with torch.no_grad():
            return tt.serving_forward(params, torch.tensor(
                [tokens], device="cuda"), cfg,
                GPT3_CAPACITY)[0].cpu().numpy()

    gen = torch.Generator().manual_seed(25)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    fa.reset_launches()
    rows = prefill_decode_bitwise(
        engine_of, forward, [prompt(7), prompt(300), prompt(2000)],
        (16, 16, 64), GPT3_CAPACITY)
    lens = torch.randint(64, 1901, (8,), generator=gen).tolist()
    news = torch.randint(8, 33, (8,), generator=gen).tolist()
    trace = [{"prompt": prompt(n), "max_new": m, "arrival": i // 2}
             for i, (n, m) in enumerate(zip(lens, news))]
    legs, launches = {}, None
    for continuous in (True, False):
        eng = engine_of()
        eng.generate(prompt(16), max_new_tokens=2)  # off the clock
        cap = _Capture(eng)
        if continuous:
            S.reset_launches()
        run = harness.run_trace(eng, trace, continuous)
        forward_steps = len(cap.times["decode"]) + sum(
            len(t) for t in cap.times["prefill"].values())
        if continuous:
            launches = dict(S.launches)
            launches["by_form"] = {f"{name}/{form}": n for (name, form), n
                                   in S.launches_by_form.items()}
            launches["forward_steps"] = forward_steps
        tokens = sum(len(t) for t in run["tokens"])
        legs["continuous" if continuous else "static"] = {
            "tokens_per_s": tokens / run["seconds"], "tokens": tokens,
            "iterations": run["iterations"], "seconds": run["seconds"],
            "decode_iteration_ms_p50": _pct(cap.times["decode"], 0.5),
            "prefill_ms_by_bucket_p50": {
                b: _pct(ts, 0.5) for b, ts in sorted(
                    cap.times["prefill"].items())},
            "out": run["tokens"]}
        del eng
    if legs["continuous"]["out"] != legs["static"]["out"]:
        raise AssertionError("GPT-3 Large: continuous and static batching "
                             "gave different tokens")
    for leg in legs.values():
        leg.pop("out")
    if any(fa.launches.values()):
        raise AssertionError(f"GPT-3 Large's serving launched flash "
                             f"kernels: {fa.launches}")
    by_form = launches["by_form"]
    if not launches["cache_attention"] or by_form["cache_attention/first"] \
            or by_form["cache_attention/sm90"] != launches["cache_attention"]:
        raise AssertionError(f"cache_attention at hd 96 left its Hopper "
                             f"form: {launches}")
    # One logits product a forward_step, on the first form (vocab 50257
    # is not a multiple of 8); every other product on the Hopper form.
    if by_form["serving_gemm/first"] != launches["forward_steps"] or \
            not by_form["serving_gemm/sm90"]:
        raise AssertionError(f"serving_gemm's forms on GPT-3 Large: "
                             f"{launches}")
    out = {"prefill_decode_rows_bitwise": rows, "prompt_lengths": lens,
           "new_tokens": news, **legs, "launches_continuous": launches,
           "device": smi_line}
    log({"phase": "gpt3_large_serving", **out})
    return out


def phase_gpt3_large(fa, smi_line, out_dir):
    """GPT-3 Large on the card (ROADMAP §B: head_dim 96): the flash
    kernels and cache_attention at head_dim 80 and 96 against their plain
    versions, timed; the model trained through transformer_lm.train
    (batch 4 x 2048, 2 warm-up and 3 timed steps, each flash kernel 24
    times a step on its Hopper form) and its weights served.  Returns
    the kernel numbers and each path's launches."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import serving as S
    from horovod_tpu_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = gpt3_large_config()
    flash = {}
    for i, (label, kw, timed) in enumerate(GPT3_FLASH_CASES):
        flash[label] = kernel_case(fa, seed=250 + i, timing=timed, **kw)
        backend = (SDP_BACKEND_F32_NAME if kw["dtype"] == torch.float32
                   else SDP_BACKEND_NAME)
        log({"phase": "gpt3_large_kernels", "case": label,
             "library": f"scaled_dot_product_attention, SDPBackend."
                        f"{backend}", "result": flash[label]})
        torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(25)
    H, hd, cap = cfg.n_heads, cfg.d_model // cfg.n_heads, GPT3_CAPACITY
    serving = {
        "attention_decode": attention_case(
            S, g, label="decode hd96", b=8, s=2, H=H, hd=hd, cap=cap,
            lengths=torch.tensor([0, 5, 100, 700, 1023, 1500, 2045, -1])),
        "attention_prefill": attention_case(
            S, g, label="prefill hd96", b=1, s=2000, H=H, hd=hd, cap=cap,
            lengths=torch.tensor([0])),
        "gemm_logits_M16": logits_gemm_case(S, g, 16, cfg.d_model,
                                            cfg.vocab_size),
        "gemm_logits_M2048": logits_gemm_case(S, g, 2048, cfg.d_model,
                                              cfg.vocab_size)}
    for key, r in serving.items():
        log({"phase": "gpt3_large_kernels", "case": key, **r})
    if serving["gemm_logits_M16"]["form"] != "first":
        raise AssertionError("the logits product at vocab 50257 left the "
                             "first form")
    torch.cuda.empty_cache()

    launches, run = train_and_profile(
        fa, cfg, model="GPT-3 Large", batch=4, seq=2048, warmup=2, steps=3,
        smi_line=smi_line, out_dir=out_dir, phase="gpt3_large_trainer")
    if run["n_params"] != GPT3_LARGE_PARAMS:
        raise AssertionError(f"GPT-3 Large has {run['n_params']} "
                             f"parameters, not {GPT3_LARGE_PARAMS}")
    params = tree_map(lambda x: x.detach(), run["params"])
    del run
    hvd.shutdown()
    torch.cuda.empty_cache()
    served = gpt3_large_serving(fa, cfg, params, smi_line)
    del params
    torch.cuda.empty_cache()
    log({"phase": "gpt3_large", "device": smi_line,
         "seconds": time.perf_counter() - t_phase})
    return {"flash": flash, "serving_cases": serving, "launches": launches,
            "serving": served}


EAGER_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32)


def eager_collectives(hvd, C):
    """Every negotiated collective on one rank with NCCL, in each dtype,
    against plain torch on the card.  One rank's reductions are the
    identity (Average divides by 1, with floor for integers); the point
    is that each runs through negotiation and NCCL in every dtype."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    checked = []

    def same(name, got, want):
        if got.device.type != "cuda" or got.dtype != want.dtype or \
                not bool(torch.equal(got, want)):
            raise AssertionError(f"eager {name}: {got} != {want}")
        checked.append(name)

    for dt in EAGER_DTYPES:
        x = (torch.rand(33, 7, generator=gen, device=dev) * 8 + 1).to(dt)
        for op in ("Sum", "Average", "Min", "Max", "Product"):
            same(f"allreduce {op} {dt}", hvd.allreduce(x, op=getattr(hvd, op)),
                 x.clone())
        ts = [x[:i + 2].clone() for i in range(4)]
        C.reset_stats()
        outs = hvd.grouped_allreduce(ts, op=hvd.Sum)
        if C.stats()["responses"] != 1 or C.stats()["tensors"] != 4:
            raise AssertionError(f"grouped allreduce {dt} was not fused into "
                                 f"one response: {C.stats()}")
        for i, (o, t) in enumerate(zip(outs, ts)):
            same(f"grouped allreduce {dt} [{i}]", o, t)
        same(f"allgather ragged {dt}", hvd.allgather(x[:5]), x[:5])
        same(f"broadcast {dt}", hvd.broadcast(x, 0), x.clone())
        same(f"alltoall splits {dt}", hvd.alltoall(x, splits=[33]), x.clone())
        same(f"reducescatter {dt}", hvd.reducescatter(x, op=hvd.Sum), x)
        ps = hvd.add_process_set([0])
        same(f"process set [0] allreduce {dt}",
             hvd.allreduce(x, op=hvd.Sum, process_set=ps), x.clone())
        hvd.remove_process_set(ps)
    joined = hvd.join()
    if joined != 0:
        raise AssertionError(f"join() returned {joined}, not 0")
    return checked


def eager_stream_order(fhvd, reps=20):
    """A 256 MB tensor written by a long kernel sequence on a side stream,
    allreduce_async_ enqueued on that stream right after: the executor
    must wait for the writes (the ReadyEvent), synchronize must make the
    caller's stream wait for the result.  Exact every time."""
    n = 64 * 2 ** 20  # float32: 256 MB
    side = torch.cuda.Stream()
    for rep in range(reps):
        with torch.cuda.stream(side):
            x = torch.full((n,), float(rep), device="cuda")
            for _ in range(40):  # ~40 passes over 256 MB
                x.add_(1.0)
            h = fhvd.allreduce_async_(x, name=f"stream.order.{rep}")
            out = fhvd.synchronize(h)
            ok = bool(torch.equal(out, torch.full_like(x, rep + 40.0)))
        if out is not x or not ok:
            raise AssertionError(f"stream order: repetition {rep} read a "
                                 f"tensor before its writes finished")
    torch.cuda.synchronize()
    return reps


def negotiated_latency(fhvd, nbytes, iters, name=None):
    """Wall ms of one synchronous in-place Sum allreduce through
    negotiation, device completion included (mean, and median of the
    single calls: the host's spread is wide); the share of it until the
    background thread has executed the response (``executed_ms``); and
    the same allreduce as one direct ``torch.distributed`` call on the
    job's group from this thread (``direct_ms``): the difference is the
    control plane's cost.  ``name`` fixes the tensor's name, as a
    training loop's are (the response cache serves it from the second
    call on); without one every call takes a new automatic name, which
    the cache never serves."""
    import torch.distributed as dist
    from horovod_tpu_torch.ops import handles

    x = torch.ones(nbytes // 4, device="cuda")
    finished = []
    finish = handles.Handle.finish

    def timed_finish(self, *args, **kwargs):
        finished.append(time.perf_counter())
        finish(self, *args, **kwargs)

    for _ in range(3):
        fhvd.allreduce_(x, op=fhvd.Sum, name=name)
    torch.cuda.synchronize()
    total = executed = 0.0
    each = []
    handles.Handle.finish = timed_finish
    try:
        for _ in range(iters):
            t0 = time.perf_counter()
            fhvd.allreduce_(x, op=fhvd.Sum, name=name)
            torch.cuda.synchronize()
            each.append(time.perf_counter() - t0)
            total += each[-1]
            executed += finished[-1] - t0
    finally:
        handles.Handle.finish = finish
    dist.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        dist.all_reduce(x)
        torch.cuda.synchronize()
    direct = time.perf_counter() - t0
    return {"ms": total / iters * 1e3, "median_ms": float(np.median(each))
            * 1e3, "executed_ms": executed / iters * 1e3,
            "direct_ms": direct / iters * 1e3}


def executor_overlap(trace_path):
    """Where the executor's device work falls in the profiled hook step.
    The flash kernels run on the step's stream; the executor's pack,
    collective and unpack run on its own.  One rank's NCCL allreduce
    launches no kernel (NCCL short-circuits a one-rank communicator), so
    the executor stream's first event stands for the first collective.
    Times in ms from the step's first device event."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in (
                      "kernel", "gpu_memcpy", "gpu_memset")]
    t0 = min(e["ts"] for e in events)
    dq = [e for e in events if "flash_bwd_dq_sm90_kernel" in e["name"]]
    main = {e["args"].get("stream") for e in dq}
    side = [e for e in events if e["args"].get("stream") not in main]
    if not dq or not side:
        raise AssertionError(f"profiled hook step: {len(dq)} dQ kernels, "
                             f"{len(side)} events on the executor's stream")
    return {"nccl_kernels": sum("nccl" in e["name"].lower() for e in events),
            "executor_events": len(side),
            "executor_busy_ms": sum(e["dur"] for e in side) / 1e3,
            "first_executor_event_ms": (min(e["ts"] for e in side) - t0) / 1e3,
            "last_executor_event_ms": (max(e["ts"] for e in side) - t0) / 1e3,
            "first_dq_ms": (min(e["ts"] for e in dq) - t0) / 1e3,
            "last_dq_ms": (max(e["ts"] for e in dq) - t0) / 1e3,
            "collective_overlaps_backward":
                min(e["ts"] for e in side) < max(e["ts"] for e in dq)}


def reinit_cache(hvd, cache: bool) -> None:
    """A new ``init`` on the card with the response cache on or off
    (``HVD_TPU_RESPONSE_CACHE`` is read at ``init``)."""
    hvd.shutdown()
    os.environ["HVD_TPU_RESPONSE_CACHE"] = "1" if cache else "0"
    hvd.init(device="cuda")


def record_fusion(C) -> list:
    """Record rank 0's cycles on the runtime the last ``init`` made: each
    cycle's data responses as a tuple of their name tuples, that is, the
    fused groups of what the cycle found ready.  Returns the list the
    cycles are appended to."""
    rt, cycles = C._runtime(), []
    negotiate = rt._negotiate

    def negotiating(batches):
        out = negotiate(batches)
        groups = tuple(tuple(r.tensor_names) for r in out[0]
                       if r.response_type in C._DATA_RESPONSES)
        if groups:
            cycles.append(groups)
        return out

    rt._negotiate = negotiating
    return cycles


def same_fusion(runs: dict, what: str) -> dict:
    """Hold runs of one program (label -> recorded cycles) to the same
    fusion.  Which tensors a cycle finds ready follows the host's timing on
    one rank: a hook that lands just after a tick splits a step's group
    over two cycles (7 responses that step where the others have 6), so
    the runs' responses a step are compared through their cycles.  A ready
    sequence (a cycle's names, in order) must be fused the same way
    wherever it occurs, in any run, and every two labels must share at
    least one such sequence."""
    seen: dict = {}
    keys = {label: set() for label in runs}
    for label, cycles in runs.items():
        for groups in cycles:
            key = tuple(n for g in groups for n in g)
            keys[label].add(key)
            first, fused = seen.setdefault(key, (label, groups))
            if fused != groups:
                raise AssertionError(
                    f"{what}: {label} fused a ready sequence of {len(key)} "
                    f"tensors from {key[0]} as {[len(g) for g in groups]}, "
                    f"{first} as {[len(g) for g in fused]}")
    for a, b in itertools.combinations(runs, 2):
        if not keys[a] & keys[b]:
            raise AssertionError(f"{what}: {a} and {b} share no cycle's "
                                 f"ready sequence")
    return {"cycles": {label: len(c) for label, c in runs.items()},
            "ready_sequences": {label: len(k) for label, k in keys.items()},
            "shared_sequences": len(set.intersection(*keys.values()))}


def negotiation_profiles(top=12):
    """``tools/negotiation_profile.py``: 1,000 synchronous 4-byte
    negotiated allreduces under cProfile, on the CPU (gloo) and on the
    card (NCCL), with the response cache off (the path before the cache)
    and on; the top functions by cumulative time, ms an op."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "negotiation_profile", os.path.join(HERE, "tools",
                                            "negotiation_profile.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = {}
    for device in ("cpu", "cuda"):
        for cache in ("0", "1"):
            os.environ["HVD_TPU_RESPONSE_CACHE"] = cache
            res = mod.profile(device, 1000, top)
            out[f"{device}.cache{cache}"] = {
                "ms_per_op": res["ms_per_op"],
                "profiled_ms_per_op": res["profiled_ms_per_op"],
                "direct_ms_per_op": res["direct_ms_per_op"],
                "top_cumulative": [
                    (r["function"], round(r["cum_ms_per_op"], 4),
                     round(r["own_ms_per_op"], 4))
                    for r in res["by_cumulative"]]}
    os.environ["HVD_TPU_RESPONSE_CACHE"] = "1"
    return out


def eager_adasum_and_features(hvd):
    """Adasum on one rank is no round: the input back exactly in every
    float dtype; int32 is refused with the reference's message.  The
    feature queries must be true of this build."""
    dev = torch.device("cuda")
    x = torch.randn(33, 7, generator=torch.Generator(device=dev)
                    .manual_seed(9), device=dev)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        got = hvd.allreduce(x.to(dt), op=hvd.Adasum)
        if got.dtype != dt or got.device.type != "cuda" or \
                not bool(torch.equal(got, x.to(dt))):
            raise AssertionError(f"Adasum on one rank changed {dt} input")
    try:
        hvd.allreduce(torch.ones(4, dtype=torch.int32, device=dev),
                      op=hvd.Adasum)
        raise AssertionError("Adasum accepted int32")
    except ValueError as exc:
        if "floating-point" not in str(exc):
            raise
    names = ("mpi_built", "mpi_enabled", "nccl_built", "gloo_built",
             "gloo_enabled", "cuda_built", "rocm_built", "ccl_built",
             "ddl_built", "xla_built", "native_built",
             "mpi_threads_supported")
    answers = {n: getattr(hvd, n)() for n in names}
    if not (answers["nccl_built"] and answers["gloo_built"]
            and answers["cuda_built"]) or answers["mpi_enabled"]:
        raise AssertionError(f"feature queries: {answers}")
    return answers


def timeline_step(hvd, step, out_dir, collective="NCCL_ALLREDUCE"):
    """One more hook step between start_timeline and stop_timeline: the
    file must parse, and each negotiated tensor must show a NEGOTIATE
    span, its top-level span marked cache hit or miss, and activities."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "eager_timeline.json")
    torch.cuda.synchronize()
    hvd.start_timeline(path)
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    hvd.stop_timeline()
    with open(path) as f:
        events = json.load(f)
    rows = {e["pid"]: e["args"]["name"] for e in events
            if e.get("name") == "process_name"}
    per: dict = {}
    for e in events:
        name = rows.get(e.get("pid"))
        if name is None or e.get("ph") != "B":
            continue
        per.setdefault(name, []).append((e.get("name"),
                                         (e.get("args") or {}).get("cache")))
    tensors = {}
    for name, spans in per.items():
        neg = [n for n, _ in spans if n.startswith("NEGOTIATE_")]
        top = [c for n, c in spans if n == "ALLREDUCE"]
        acts = [n for n, _ in spans if n not in ("ALLREDUCE",)
                and not n.startswith("NEGOTIATE_")]
        if len(neg) != 1 or len(top) != 1 or top[0] not in ("hit", "miss") \
                or collective not in acts:
            raise AssertionError(f"timeline: tensor {name}: {spans}")
        tensors[name] = top[0]
    if len(tensors) != 18:
        raise AssertionError(f"timeline: {len(tensors)} tensors, not 18: "
                             f"{sorted(tensors)}")
    return {"events": len(events), "tensors": len(tensors),
            "cache": {c: sum(v == c for v in tensors.values())
                      for c in ("hit", "miss")},
            "step_ms_with_timeline": step_ms, "file": path}


def phase_eager(fa, smi_line, out_dir):
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.frontends.torch as fhvd
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.utils.tree import tree_leaves

    torch.cuda.empty_cache()
    # First, where a negotiated allreduce's host time goes.
    log({"phase": "eager_profile", "what": "cProfile of 1,000 synchronous "
         "4 B negotiated allreduces (tools/negotiation_profile.py), ms an "
         "op; top functions (function, cumulative, own)",
         "device": smi_line, **negotiation_profiles()})
    hvd.init(device="cuda")
    checked = eager_collectives(hvd, C)
    log({"phase": "eager", "check": "collectives against plain torch on the "
         "card", "dtypes": [str(d) for d in EAGER_DTYPES],
         "cases": len(checked)})
    reps = eager_stream_order(fhvd)
    log({"phase": "eager", "check": "stream order, 256 MB on a side stream",
         "repetitions": reps, "exact": True})
    log({"phase": "eager", "check": "Adasum on one rank and the feature "
         "queries", "features": eager_adasum_and_features(hvd)})

    # The hook path against the monolithic step, and the hook path with
    # the response cache on against off: 3 steps each from the same init
    # and batches; two monolithic runs show the run-to-run difference
    # the hook path is held to; the cache must change no bit.
    cfg = transformer_lm.bench_config()
    batch, seq = 8, 1024

    def three_steps(hooks):
        run = transformer_lm.train(cfg, batch=batch, seq=seq, steps=3,
                                   device="cuda", seed=0, hooks=hooks)
        return run["losses"], [p.detach().clone()
                               for p in tree_leaves(run["params"])]

    def diff(a, b):
        return max([abs(x - y) for x, y in zip(a[0], b[0])]
                   + [float((p.float() - q.float()).abs().max())
                      for p, q in zip(a[1], b[1])])

    mono_a, mono_b = three_steps(False), three_steps(False)
    hook = three_steps(True)
    reinit_cache(hvd, False)
    hook_off = three_steps(True)
    reinit_cache(hvd, True)
    run_to_run, hook_vs_mono = diff(mono_a, mono_b), diff(hook, mono_a)
    cache_on_vs_off = diff(hook, hook_off)
    log({"phase": "eager", "check": "hook path against make_train_step, "
         "and the hook path with the response cache on against off, "
         "GPT-2-small, 3 steps", "monolithic_run_to_run_max_diff": run_to_run,
         "hook_vs_monolithic_max_diff": hook_vs_mono,
         "hook_cache_on_vs_off_max_diff": cache_on_vs_off,
         "losses_monolithic": mono_a[0], "losses_hook": hook[0],
         "losses_hook_cache_off": hook_off[0]})
    if hook_vs_mono > run_to_run:
        raise AssertionError(
            f"the hook path differs from the monolithic step by "
            f"{hook_vs_mono}, two monolithic runs by {run_to_run}")
    if cache_on_vs_off != 0.0:
        raise AssertionError(f"the response cache changed the hook path by "
                             f"{cache_on_vs_off}")
    del mono_a, mono_b, hook, hook_off
    torch.cuda.empty_cache()

    # Timed in turns: monolithic, hook (cache on), hook (off), hook
    # (off), hook (on), monolithic; 2 warm-up and 5 timed steps each, the
    # counts of the timed steps only.  One hook step profiled, one under
    # the timeline.
    warmup, steps = 2, 5
    turns = (("monolithic", False, True), ("hook", True, True),
             ("hook_cache_off", True, False), ("hook_cache_off", True, False),
             ("hook", True, True), ("monolithic", False, True))
    timed = {"monolithic": [], "hook": [], "hook_cache_off": []}
    fusion: dict = {"hook": [], "hook_cache_off": []}
    for path, hooks, cache in turns:
        reinit_cache(hvd, cache)
        cycles = record_fusion(C)
        fa.reset_launches()
        run = transformer_lm.train(cfg, batch=batch, seq=seq, steps=warmup,
                                   device="cuda", seed=0, hooks=hooks)
        C.reset_stats()
        losses = list(run["losses"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(run["step"](run["params"], run["data"]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if hooks:
            fusion[path] += cycles
        losses = [float(x) for x in losses]
        launches, stats = dict(fa.launches), C.stats()
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"loss not finite and falling: {losses}")
        if any(c != cfg.n_layers * (warmup + steps)
               for c in launches.values()):
            raise AssertionError(f"each kernel must launch {cfg.n_layers} "
                                 f"times a step: {launches}")
        leaves = tree_leaves(run["params"])
        state = [t for st in run["optimizer"].state.values()
                 for t in st.values() if isinstance(t, torch.Tensor)
                 and t.dim() > 0]
        if not state or any(t.device.type != "cuda" for t in leaves + state
                            + [p.grad for p in leaves if p.grad is not None]
                            + list(run["data"])):
            raise AssertionError("a tensor of the step is off the card")
        per_step = {k: v / steps for k, v in stats.items()}
        if hooks and per_step["tensors"] != 18:
            raise AssertionError(f"hook step: {per_step['tensors']} "
                                 f"negotiated tensors, not 18")
        if path == "hook" and (per_step["cache_hits"] != 18
                               or per_step["cache_misses"] != 0):
            raise AssertionError(f"hook step with the cache after warm-up: "
                                 f"{per_step}")
        timed[path].append({
            "step_ms": seconds / steps * 1e3,
            "tokens_per_s": batch * seq * steps / seconds,
            "negotiated_tensors_per_step": per_step["tensors"],
            "cache_hits_per_step": per_step["cache_hits"],
            "cache_misses_per_step": per_step["cache_misses"],
            "responses_per_step": per_step["responses"],
            "nccl_calls_per_step": per_step["collective_calls"],
            "launches_per_step": {k: v / (warmup + steps)
                                  for k, v in launches.items()},
            "losses": losses})

        def one_step():
            run["step"](run["params"], run["data"])

        if path == "hook" and "hook_profile" not in timed:
            C.reset_stats()
            prof = profile_step(one_step, out_dir, "eager")
            prof.update(executor_overlap(os.path.join(
                out_dir, "eager_trace.json")))
            prof["responses"] = C.stats()["responses"]
            timed["hook_profile"] = prof
            timed["hook_timeline"] = timeline_step(hvd, one_step, out_dir)
        del run, leaves, state
        torch.cuda.empty_cache()
    for path in ("monolithic", "hook", "hook_cache_off"):
        timed[f"{path}_mean_step_ms"] = float(np.mean(
            [r["step_ms"] for r in timed[path]]))
    timed["fusion"] = same_fusion(fusion, "the hook step with the cache "
                                  "on and off")
    log({"phase": "eager_trainer", "model": "GPT-2-small", "batch": batch,
         "seq": seq, "dtype": "bfloat16", "device": smi_line, **timed})

    # Negotiated latency, the cache on, off, off, on.
    lat: dict = {}
    for cache in (True, False, False, True):
        reinit_cache(hvd, cache)
        key = "cache_on" if cache else "cache_off"
        for label, nbytes, iters, name in (
                ("4B", 4, 200, "latency.4B"),
                ("4B_unnamed", 4, 200, None),
                ("64MB", 64 * 2 ** 20, 20, "latency.64MB")):
            lat.setdefault(key, {}).setdefault(label, []).append({
                **negotiated_latency(fhvd, nbytes, iters, name),
                "bytes": nbytes,
                # pack (read + write) and unpack (read + write)
                "bound_ms": 4 * nbytes / PEAK_BYTES * 1e3})
    log({"phase": "eager_latency", "what": "synchronous in-place Sum "
         "allreduce through negotiation, one rank, NCCL, the response "
         "cache on and off in turns; a fixed name, and (4B_unnamed) a "
         "new automatic name each call", "device": smi_line, **lat})
    log({"phase": "eager_native", "what": "the hook step and the named "
         "negotiated latencies with the native coordinator (native/, "
         "built by g++) and with HVD_TPU_DISABLE_NATIVE=1, in turns",
         "device": smi_line, **native_vs_python(hvd, fhvd, fa, C, cfg)})
    log({"phase": "eager_telemetry", "device": smi_line,
         **eager_telemetry(hvd, cfg, out_dir)})
    hvd.shutdown()


def eager_telemetry(hvd, cfg, out_dir, batch=8, seq=1024):
    """Telemetry on the card (ROADMAP A.5.1): the hook step's ms with the
    flight recorder on and off, in turns (recorded, not claimed); a
    seeded stall's flight dump naming the tensor; the response cache's
    flush and downgrade records; cluster_metrics at one rank; init()
    serving /metrics on HVD_TPU_METRICS_PORT.  One card is one rank, so
    the stall is seeded on a second native coordinator of 2 ranks beside
    the runtime's, whose warnings take the path the runtime's cycle gives
    them (stall_event).  This check, in this process after the phases
    before it, is what showed the native library's exported copy of
    libstdc++ colliding with torch's (native/lib.py ``CXX_FLAGS``)."""
    import shutil
    import urllib.request

    import horovod_tpu_torch.telemetry as telemetry
    from horovod_tpu_torch.core import state
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.ops import cache as cache_mod
    from horovod_tpu_torch.ops import wire
    from horovod_tpu_torch.ops.coordinator import Coordinator
    from horovod_tpu_torch.telemetry import flight

    out = {}
    run = transformer_lm.train(cfg, batch=batch, seq=seq, steps=2,
                               device="cuda", seed=0, hooks=True)
    ms = {"on": [], "off": []}
    for on in (True, False, False, True, True, False):
        flight.recorder.enabled = on
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run["step"](run["params"], run["data"])
        torch.cuda.synchronize()
        ms["on" if on else "off"].append((time.perf_counter() - t0) / 5e-3)
    flight.recorder.enabled = flight.flight_enabled_env()
    out["hook_step_ms_flight_on"] = ms["on"]
    out["hook_step_ms_flight_off"] = ms["off"]
    del run
    torch.cuda.empty_cache()
    # A seeded stall: rank 0 of 2 submits, rank 1 never does.
    fdir = os.path.join(out_dir, "flight")
    shutil.rmtree(fdir, ignore_errors=True)
    os.environ["HVD_TPU_FLIGHT_DIR"] = fdir
    try:
        flight.recorder._last_dump.pop("stall", None)
        coord = Coordinator(size=2, fusion_threshold=1 << 20)
        if type(coord._impl).__name__ != "NativeCoordinator":
            raise AssertionError(f"the seeded stall runs "
                                 f"{type(coord._impl).__name__}")
        coord.submit(wire.Request(
            request_rank=0, request_type=wire.RequestType.ALLREDUCE,
            tensor_type=wire.DataType.FLOAT32, tensor_name="stalled.op",
            tensor_shape=(4,)))
        telemetry.stall_event(coord.check_stalled(threshold=-1.0))
        coord.close()
        # A hit that raced a flush: downgraded to its stored request.
        cache = cache_mod.ResponseCache(rank=0)
        coord = Coordinator(2, 1 << 20, cache=cache)
        for r in range(2):
            coord.submit(wire.Request(r, wire.RequestType.ALLREDUCE,
                                      wire.DataType.FLOAT32, "t", -1, -1,
                                      (4,), wire.ReduceOp.SUM, 0, ()))
        for resp in coord.poll_responses({}):
            cache.observe_response(resp)
        epoch = cache.epoch
        cache.flush("seeded", broadcast=True)
        if cache.hit_from_wire(0, 1, epoch) is None:
            raise AssertionError("the seeded downgrade did not happen")
        coord.close()
    finally:
        os.environ.pop("HVD_TPU_FLIGHT_DIR", None)
    dumps = sorted(f for f in os.listdir(fdir) if "stall" in f)
    if not dumps:
        raise AssertionError(f"no stall dump in {os.listdir(fdir)}")
    with open(os.path.join(fdir, dumps[-1])) as f:
        payload = json.load(f)
    tail = [e for e in payload["events"] if e["kind"] == "stall"][-1]
    if "stalled.op" not in tail["args"][0] or \
            "waiting on replicas: [1]" not in tail["args"][0]:
        raise AssertionError(f"the stall dump's tail: {tail}")
    kinds = [e[1] for e in flight.snapshot()]
    for kind in ("cache_flush", "cache_downgrade", "submit", "stall"):
        if kind not in kinds:
            raise AssertionError(f"no {kind} record in the flight ring")
    out["stall_dump"] = {"file": dumps[-1], "tail": tail["args"][0][:120],
                         "events": len(payload["events"]),
                         "metrics_tail": len(payload.get("metrics", {}))}
    out["flight_record_kinds"] = sorted(set(kinds))
    # cluster_metrics at one rank.
    hvd.allreduce(torch.ones(4, device="cuda"), name="tel.agg")
    agg = hvd.cluster_metrics()
    if agg["collective.submitted"]["ranks"] != 1 or \
            agg["collective.negotiate_seconds"]["count"] < 1:
        raise AssertionError(f"cluster_metrics: {agg['collective.submitted']}")
    out["cluster_metrics_collective_submitted"] = \
        agg["collective.submitted"]["sum"]
    # init() with HVD_TPU_METRICS_PORT serves /metrics; shutdown closes it.
    hvd.shutdown()
    os.environ.update(HVD_TPU_METRICS_PORT="0",
                      HVD_TPU_METRICS_HOST="127.0.0.1")
    try:
        hvd.init(device="cuda")
        port = state._state.metrics_exporter.port
        hvd.allreduce(torch.ones(4, device="cuda"), name="tel.exp")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        if "hvd_collective_submitted" not in text:
            raise AssertionError("/metrics lacks collective.submitted")
        hvd.shutdown()
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                   timeout=5)
            raise AssertionError("the exporter outlived shutdown()")
        except OSError:
            pass
    finally:
        os.environ.pop("HVD_TPU_METRICS_PORT", None)
        os.environ.pop("HVD_TPU_METRICS_HOST", None)
    hvd.init(device="cuda")
    out["exporter_served_metrics_lines"] = len(text.splitlines())
    return out


def native_vs_python(hvd, fhvd, fa, C, cfg, batch=8, seq=1024):
    """GPT-2-small's hook step, then the named 4 B and 64 MB negotiated
    latencies, with the native coordinator and handle manager and with the
    Python twins (HVD_TPU_DISABLE_NATIVE=1), in turns (native, python,
    python, native), each from the same weights and batches: losses and
    parameters after 2 + 5 steps bitwise equal, the same cache hits and
    misses a step, and the same fused responses for the same ready tensors
    in a cycle (:func:`same_fusion`)."""
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.native import lib as native
    from horovod_tpu_torch.utils.tree import tree_leaves

    if not hvd.native_built():
        raise AssertionError("native_built() is false on the card")
    warmup, steps = 2, 5
    legs: dict = {"native": [], "python": []}
    fusion: dict = {"native": [], "python": []}
    ref = None
    try:
        for leg in ("native", "python", "python", "native"):
            hvd.shutdown()
            if leg == "python":
                os.environ[native.DISABLE_ENV] = "1"
            else:
                os.environ.pop(native.DISABLE_ENV, None)
            hvd.init(device="cuda")
            cycles = record_fusion(C)
            impl = type(C._runtime().coordinator._impl).__name__
            if impl != ("NativeCoordinator" if leg == "native"
                        else "PyCoordinator"):
                raise AssertionError(f"{leg} leg runs {impl}")
            fa.reset_launches()
            run = transformer_lm.train(cfg, batch=batch, seq=seq,
                                       steps=warmup, device="cuda", seed=0,
                                       hooks=True)
            C.reset_stats()
            losses = list(run["losses"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                losses.append(run["step"](run["params"], run["data"]))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            fusion[leg] += cycles
            stats = C.stats()
            got = ([float(x) for x in losses],
                   [p.detach().clone() for p in tree_leaves(run["params"])],
                   stats["cache_hits"] / steps, stats["cache_misses"] / steps,
                   stats["responses"] / steps)
            if ref is None:
                ref = got
            elif got[0] != ref[0] or got[2:4] != ref[2:4] or not all(
                    torch.equal(a, b) for a, b in zip(got[1], ref[1])):
                raise AssertionError(
                    f"the {leg} leg's hook path differs from the native "
                    f"leg's: losses {got[0]} / {ref[0]}, hits and misses "
                    f"a step {got[2:4]} / {ref[2:4]}")
            if any(c != cfg.n_layers * (warmup + steps)
                   for c in fa.launches.values()):
                raise AssertionError(f"{leg} leg: {fa.launches}")
            del run
            legs[leg].append({
                "step_ms": seconds / steps * 1e3,
                "responses_per_step": got[4], "cache_hits_per_step": got[2],
                "cache_misses_per_step": got[3],
                "latency": {label: negotiated_latency(fhvd, nbytes, iters,
                                                      name)
                            for label, nbytes, iters, name in (
                                ("4B", 4, 200, "latency.4B"),
                                ("64MB", 64 * 2 ** 20, 20, "latency.64MB"))}})
            torch.cuda.empty_cache()
    finally:
        os.environ.pop(native.DISABLE_ENV, None)
    return {"bitwise": True, "losses": ref[0],
            "fusion": same_fusion(fusion, "the hook step with the native "
                                  "and the Python coordinator"), **legs}


# The quant phase: the int8/int4 codec kernels (ops/csrc/quant.cu) against
# their plain versions, bit for bit; a one-rank quantized allreduce; and
# GPT-2-small's hook path under the int8 and int4 policies.
QUANT_SHAPES = (("embedding", 25_165_824), ("fused_64MB", 16 * 2 ** 20))
# (block, r, C): blocks 6 (the first form) to 1024 at r = 1, and r = 4
# rows of C = 768, 1536, 4096, whose frames keep rows after the first
# only 2-, 4- or 8-byte aligned (the one pass's code store width).
QUANT_EDGE_SHAPES = ((6, 1, 3072), (64, 1, 4096), (128, 1, 4096),
                     (256, 1, 4096), (512, 1, 4096), (1024, 1, 4096),
                     (256, 4, 768), (256, 4, 1536), (256, 4, 4096))
QUANT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# LayerNorm scales and biases and the FFN biases stay uncompressed.
QUANT_RULES = [(r"ln(1|2|_f)/|(b_in|b_out|bias)$", "none")]


def quant_format(bits, stochastic, block=256):
    from horovod_tpu_torch.ops import compression as qc

    return qc.WireFormat(kind="quant", name=f"int{bits}", bits=bits,
                         block=block, stochastic=stochastic)


def quant_bytes(r, C, fmt, in_item, residual):
    """Bytes quant_pack must move: rows read once; codes, scales and the
    residual (in the input dtype) written once."""
    return r * C * (in_item + fmt.bits / 8 + (in_item if residual else 0)) \
        + r * (C // fmt.block) * 2


def unpack_bytes(r, C, fmt, sum_rows):
    """Bytes unpack_dequantize must move: the frames read once, f32
    out."""
    return r * (C * fmt.bits / 8 + (C // fmt.block) * 2) \
        + (C if sum_rows else r * C) * 4


# quant_pack's operations an element, counted in the function
# (ops/csrc/quant.cu), not in what the compiler emitted for it.
# threefry2x32: 20 rounds of an add, a rotate and an xor, and 2 + 5 x 2
# key-schedule adds.  The dither: (x0 ^ x1) & 0xFF, one three-input logic
# op; its conversion to float and scale, 2.  quantize_one: divide, add,
# floor, max, min, convert, 6.  The residual: convert, multiply, subtract,
# 3 (the f32 path; bf16's roundings are left out).  The block's amax, 1.
# Rotates and logic ops issue only to the integer ALU, 64 lanes an SM a
# clock on an H100; an add may also issue as IMAD to the FMA pipe, and an
# SM issues 128 lanes a clock in all.  Leaving ops out can only lower
# the bound.
QUANT_PACK_ALU_OPS = 20 + 20 + 1
QUANT_PACK_OPS = QUANT_PACK_ALU_OPS + (20 + 2 + 10) + 2 + 6 + 3 + 1
ALU_LANES_PER_SM, ISSUE_LANES_PER_SM = 64, 128


def quant_pack_ops_clocks():
    """SM-clocks an element of quant_pack needs at the least: its ALU-only
    ops at 64 lanes or all its ops at 128 lanes, whichever is more."""
    return max(QUANT_PACK_ALU_OPS / ALU_LANES_PER_SM,
               QUANT_PACK_OPS / ISSUE_LANES_PER_SM)


# quant_pack's kernels in the built library's SASS: int8, bf16 and f32
# in; the one pass at the default block (one chunk of 8 a lane) with
# 8-byte code stores.
QUANT_PACK_SASS = {
    "first": ("quant_pack_kernel", {torch.bfloat16: "13__nv_bfloat16Li8E",
                                    torch.float32: "fLi8E"}),
    "one_pass": ("quant_pack_one_pass_kernel",
                 {torch.bfloat16: "13__nv_bfloat16Li8ELi1ELi8E",
                  torch.float32: "fLi8ELi1ELi8E"})}
# Opcodes that issue to the integer ALU (logic, shifts, 3-input adds,
# byte permutes, min/max, compares, selects, LEA).  IMAD (and its
# IADD/MOV/SHL/WIDE forms) goes to the FMA pipe; VIADD is counted apart.
ALU_OPCODES = ("LOP3", "SHF", "IADD3", "PRMT", "IMNMX", "VIMNMX", "FMNMX",
               "ISETP", "FSETP", "SEL", "FSEL", "LEA", "PLOP3")


def quant_pack_sass_ops(out_dir):
    """A cross-check of the count above: the instructions an element of
    quant_pack (int8; bf16 and f32 in) in the SASS of the built
    libquant.so (``cuobjdump -sass``, saved as ``quant_sass.txt``), for
    each form: ``{form: {dtype: counts}}`` (:func:`_loop_ops`)."""
    from horovod_tpu_torch.ops import _build

    lib = _build.BUILD_ROOT / _build._source_hash() / "libquant.so"
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "quant_sass.txt"), "w") as f:
        f.write(sass)
    funcs = re.split(r"\n\s*Function : ", sass)

    def body(kernel, mangled):
        return next(f for f in funcs
                    if f"{len(kernel)}{kernel}I{mangled}" in f.split("\n")[0])

    return {form: {dtype: _loop_ops(body(kernel, mangled),
                                    8 if form == "one_pass" else None)
                   for dtype, mangled in names.items()}
            for form, (kernel, names) in QUANT_PACK_SASS.items()}


def _loop_ops(body, elements=None):
    """Counts an element in a kernel's per-element loop.  The one pass
    (``elements`` a lane an iteration): its tile loop, the backward branch
    that encloses the most instructions, however its rotates are emitted.
    The first form: the innermost loop holding the most funnel shifts
    (SHF.L.W, 20 a threefry, one threefry an element)."""
    insts = []
    for line in body.split("\n"):
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            insts.append((int(m.group(1), 16), text.split()[0], text))
    loops = []
    for addr, op, text in insts:
        t = re.search(r"\b0x([0-9a-f]+)\s*$", text)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            lo = int(t.group(1), 16)
            region = [o for a, o, _ in insts if lo <= a <= addr]
            rot = sum(o.startswith("SHF.L.W") for o in region)
            loops.append((rot, -(addr - lo), region))
    if elements is None:
        rot, _neg_span, region = max(loops, key=lambda lp: lp[:2])
        if rot == 0 or rot % 20:
            raise AssertionError(f"quant_pack's loop holds {rot} funnel "
                                 f"shifts, not a whole number of threefry "
                                 f"calls")
        elements = rot // 20
    else:
        region = max(loops, key=lambda lp: len(lp[2]))[2]

    def per(pred):
        return sum(1 for o in region if pred(o)) / elements

    return {"shf_per_element": per(lambda o: o.startswith("SHF")),
            "lop3_per_element": per(lambda o: o.startswith("LOP3")),
            "alu_ops_per_element": per(
                lambda o: o.split(".")[0] in ALU_OPCODES),
            "imad_per_element": per(lambda o: o.startswith("IMAD")),
            "viadd_per_element": per(lambda o: o.startswith("VIADD")),
            "instructions_per_element": len(region) / elements,
            "elements_per_iteration": elements}


def sm_clock_under_load(fn, seconds=0.3):
    """nvidia-smi's SM clock (MHz) while ``fn`` runs back to back on a
    second thread, and the card's maximum."""
    stop = threading.Event()

    def spin():
        torch.cuda.set_device(0)
        while not stop.is_set():
            fn()

    th = threading.Thread(target=spin)
    th.start()
    try:
        time.sleep(seconds)
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.strip().split("\n")[0]
    finally:
        stop.set()
        th.join()
        torch.cuda.synchronize()
    sm, sm_max = (float(x) for x in out.split(","))
    return {"sm_clock_mhz_under_load": sm, "sm_clock_mhz_max": sm_max}


def quant_rows(r, C, dtype, seed):
    """Seeded rows (C a multiple of 256, at least 768) whose blocks span
    many magnitudes (within float16's range), with an all-zero block, a
    block with one huge value, in f32 a block of subnormals and, in the
    last 256 elements, a NaN block, a +inf block, a -inf block and a
    block with a NaN and a +inf (at block 64; one block of all of them
    at 256)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mag = torch.exp(3 * torch.randn(r, C // 256, 1, generator=gen,
                                    device="cuda")).clamp(1e-6, 1e3)
    x = (torch.randn(r, C // 256, 256, generator=gen, device="cuda")
         * mag).reshape(r, C)
    x[:, :256] = 0.0
    x[:, 300] = 3e4
    if dtype == torch.float32 and C >= 1024:
        x[:, 512:768] = torch.linspace(-1e-39, 1e-39, 256, device="cuda")
    x[:, C - 256 + 5] = float("nan")
    x[:, C - 192 + 7] = float("inf")
    x[:, C - 128 + 9] = -float("inf")
    x[:, C - 64 + 1] = float("nan")
    x[:, C - 64 + 2] = float("inf")
    return x.to(dtype)


def bitwise_err(a, b):
    """max |a - b| over the elements whose bits differ: 0 where every
    element is bitwise equal, NaN and inf included."""
    a, b = a.float(), b.float()
    same = a.view(torch.int32) == b.view(torch.int32)
    return float(torch.where(same, torch.zeros_like(a), (a - b).abs()).max())


def quant_kernel_case(tq, fmt, r, C, dtype, seed, sum_rows=True,
                      timing=False, sass=None, residual=True, rows=None):
    """Each kernel against its plain version on the same inputs, bit for
    bit (torch.equal of the bytes): quant_pack in the form
    quant_pack_form picks and, where that is the one pass, in the first
    form too, each launch counted in its form.  With ``timing`` (and the
    residual) the two forms are timed in turns (first, one pass, one
    pass, first) beside the plain version, with the bound: bytes / 3.35
    TB/s, and for quant_pack also its operations
    (:func:`quant_pack_ops_clocks`) at the SM clock read under its load,
    whichever is larger; ``sass`` (:func:`quant_pack_sass_ops`) is
    reported beside them."""
    from horovod_tpu_torch.ops import compression as qc

    rows = quant_rows(r, C, dtype, seed) if rows is None else rows
    key = qc.step_key(seed, 3)
    expect = tq.quant_pack_form(r, C, dtype, fmt, rows.data_ptr())[0]
    res_plain = torch.empty_like(rows) if residual else None
    wire_plain = tq.quant_pack_plain(rows, fmt, key, res_plain)
    deq_plain = tq.unpack_dequantize_plain(wire_plain, C, fmt, False)
    out, errs = {}, {"quant_pack": 0.0}
    for form in (None, "first") if expect == "one_pass" else (None,):
        tq.reset_launches()
        res = torch.empty_like(rows) if residual else None
        got = tq.quant_pack(rows, fmt, key, res, form=form)
        torch.cuda.synchronize()
        took = form or expect
        if tq.form_launches != {f: int(f == took) for f in tq.FORMS}:
            raise AssertionError(f"quant_pack's {took} form: launches "
                                 f"{tq.form_launches}")
        out[f"{took}_quant_pack_equal"] = bool(torch.equal(got, wire_plain))
        errs["quant_pack"] = max(errs["quant_pack"], bitwise_err(
            tq.unpack_dequantize_plain(got, C, fmt, False), deq_plain))
        if residual:
            out[f"{took}_residual_equal"] = bool(torch.equal(
                res.view(torch.uint8), res_plain.view(torch.uint8)))
            errs["quant_pack"] = max(errs["quant_pack"],
                                     bitwise_err(res, res_plain))
        if form is None:
            wire, res_main = got, res
    for flag in (False, True) if r > 1 else (sum_rows,):
        got = tq.unpack_dequantize(wire, C, fmt, flag)
        want = tq.unpack_dequantize_plain(wire, C, fmt, flag)
        out[f"unpack_sum_{flag}_equal"] = bool(torch.equal(
            got.view(torch.int32), want.view(torch.int32)))
        errs["unpack_dequantize"] = max(errs.get("unpack_dequantize", 0.0),
                                        bitwise_err(got, want))
    torch.cuda.synchronize()
    if not all(out.values()):  # the equality flags
        raise AssertionError(f"quant kernels differ from their plain "
                             f"versions: {fmt} r{r} C{C} {dtype}: {out}")
    out["form"] = expect
    out.update({f"{k}_max_abs_err": v for k, v in errs.items()})
    if timing:
        res = res_main
        item = rows.element_size()
        turns = {"first": [], "one_pass": []}
        for form in ("first", "one_pass", "one_pass", "first"):
            turns[form].append(cuda_time_ms(
                lambda form=form: tq.quant_pack(rows, fmt, key, res,
                                                form=form), iters=10))
        out["quant_pack_turns_ms"] = turns
        out["quant_pack_ms"] = float(np.mean(turns["one_pass"]))
        out["quant_pack_first_form_ms"] = float(np.mean(turns["first"]))
        out["quant_pack_plain_ms"] = cuda_time_ms(
            lambda: tq.quant_pack_plain(rows, fmt, key, res_plain), iters=3,
            warmup=1)
        bytes_ms = quant_bytes(r, C, fmt, item, True) / PEAK_BYTES * 1e3
        out["quant_pack_bytes_bound_ms"] = bytes_ms
        out["quant_pack_bound_ms"], out["quant_pack_bound_by"] = \
            bytes_ms, "bytes"
        # The operations at the clock read under this kernel's load.
        clk = sm_clock_under_load(lambda: tq.quant_pack(rows, fmt, key, res))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        ops_ms = r * C * quant_pack_ops_clocks() / (
            sms * clk["sm_clock_mhz_under_load"] * 1e6) * 1e3
        out.update(clk, quant_pack_ops_bound_ms=ops_ms,
                   quant_pack_alu_ops_per_element=QUANT_PACK_ALU_OPS,
                   quant_pack_ops_per_element=QUANT_PACK_OPS)
        if sass is not None:
            out["quant_pack_sass"] = {form: counts[dtype]
                                      for form, counts in sass.items()}
        if ops_ms > bytes_ms:
            out["quant_pack_bound_ms"], out["quant_pack_bound_by"] = \
                ops_ms, "operations"
        out["quant_pack_share_of_bound"] = \
            out["quant_pack_bound_ms"] / out["quant_pack_ms"]
        out["quant_pack_first_form_share_of_bound"] = \
            out["quant_pack_bound_ms"] / out["quant_pack_first_form_ms"]
        out["unpack_dequantize_ms"] = cuda_time_ms(
            lambda: tq.unpack_dequantize(wire, C, fmt, sum_rows), iters=10)
        out["unpack_dequantize_plain_ms"] = cuda_time_ms(
            lambda: tq.unpack_dequantize_plain(wire, C, fmt, sum_rows),
            iters=3, warmup=1)
        out["unpack_dequantize_bound_ms"] = unpack_bytes(
            r, C, fmt, sum_rows) / PEAK_BYTES * 1e3
    return out


def quant_one_rank_allreduce(hvd, qc, MK):
    """hvd.allreduce under set_compression("int8") on one rank: bitwise
    the plain reference_allreduce of the same input and tick, within one
    quantization step per phase of the exact sum, and the residual
    carried to the next tick."""
    hvd.set_compression(default="int8")
    fmt = qc.wire_format("int8")
    T = 3_000_001  # a tail that needs padding
    x = torch.randn(T, generator=torch.Generator(device="cuda").manual_seed(
        5), device="cuda")
    res = torch.zeros(1, T, device="cuda")
    Tp = qc.padded_length(T, 1, fmt.block)

    def blocks(v):
        return torch.nn.functional.pad(v, (0, Tp - T)).view(-1, fmt.block)

    for tick in range(2):
        vin = x + res[0]  # what this tick sends: x and the last residual
        got = hvd.allreduce(x, op=hvd.Sum, name="quant.one_rank")
        want, res = qc.reference_allreduce(x[None], fmt, tick, residuals=res)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"one-rank int8 allreduce, tick {tick}: "
                                 f"differs from reference_allreduce")
        # Within one step of each phase's codebook of the exact sum: the
        # phase-1 scales, and phase 2's of the reduced chunk.
        key = qc.step_key(qc.quant_seed(), tick)
        q1, s1 = qc.quantize_blocks(blocks(vin).reshape(1, -1), fmt,
                                    qc._noise_key(key, 1, 0))
        red = qc.dequantize_blocks(q1, s1, fmt)
        step1 = s1.float().reshape(-1)
        step2 = qc._pow2_scale(red.view(-1, fmt.block).abs().amax(-1), 8)
        err = blocks((got - vin).abs()).amax(-1)
        if not bool((err <= step1 + step2).all()):
            raise AssertionError("one-rank int8 allreduce: an error beyond "
                                 "one quantization step per phase")
    kept = MK.residual_count()
    if kept != 1:
        raise AssertionError("the error-feedback residual was not kept")
    hvd.set_compression()
    return {"elements": T, "ticks": 2, "bitwise": True,
            "max_abs_err_vs_sent": float((got - vin).abs().max()),
            "residuals_kept": kept}


# Kernel-name substrings of the codec in a trace: quant_pack's two forms
# (quant_pack_kernel, quant_pack_one_pass_kernel) and unpack_dequantize.
QUANT_TRACE_NAMES = {"quant_pack_one_pass": "hvdquant::quant_pack_one_pass",
                     "quant_pack_first": "hvdquant::quant_pack_kernel",
                     "unpack_dequantize": "hvdquant::unpack_dequantize"}


def quant_trace_ms(trace_path):
    """Device ms of each quantization kernel in a chrome trace."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "kernel"]
    out = {}
    for name, pattern in QUANT_TRACE_NAMES.items():
        hits = [e["dur"] for e in events if pattern in e["name"]]
        out[name] = {"ms": sum(hits) / 1e3, "launches": len(hits)}
    return out


def record_quant_calls(tq, step):
    """One step with the two wrappers recording each call's shape: the
    bytes the quantized path must move a step, and quant_pack's calls a
    step by input dtype."""
    calls, dtypes = [], {}
    pack, unpack = tq.quant_pack, tq.unpack_dequantize

    def pack_rec(rows, fmt, key, residual_out=None):
        calls.append(quant_bytes(rows.shape[0], rows.shape[1], fmt,
                                 rows.element_size(),
                                 residual_out is not None))
        name = str(rows.dtype).replace("torch.", "")
        dtypes[name] = dtypes.get(name, 0) + 1
        return pack(rows, fmt, key, residual_out)

    def unpack_rec(wire, C, fmt, sum_rows):
        calls.append(unpack_bytes(wire.shape[0], C, fmt, sum_rows))
        return unpack(wire, C, fmt, sum_rows)

    tq.quant_pack, tq.unpack_dequantize = pack_rec, unpack_rec
    try:
        step()
        torch.cuda.synchronize()
    finally:
        tq.quant_pack, tq.unpack_dequantize = pack, unpack
    return sum(calls), dtypes


def phase_quant(fa, smi_line, out_dir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.ops import compression as qc
    from horovod_tpu_torch.ops import megakernel as MK
    from horovod_tpu_torch.ops import quant as tq
    from horovod_tpu_torch.utils.tree import tree_leaves

    torch.cuda.empty_cache()
    # 1. Each kernel against its plain version, bit for bit; quant_pack
    # in both forms wherever the one pass applies.
    cases, seed, forms = [], 0, {form: 0 for form in tq.FORMS}

    def case(name, expect, *args, **kw):
        got = quant_kernel_case(tq, *args, **kw)
        if got["form"] != expect:
            raise AssertionError(f"{name}: quant_pack_form chose "
                                 f"{got['form']}, not {expect}")
        forms[expect] += 1
        cases.append(name)

    for (label, C), dtype, bits, stochastic in itertools.product(
            QUANT_SHAPES, QUANT_DTYPES, (8, 4), (True, False)):
        seed += 1
        case(f"{label} {dtype} int{bits} "
             f"{'stochastic' if stochastic else 'nearest'}", "one_pass",
             quant_format(bits, stochastic), 1, C, dtype, seed)
    for bits in (8, 4):  # r = 4 with a row sum; a padded tail
        case(f"r4 C4096 f32 int{bits}", "one_pass", quant_format(bits, True),
             4, 4096, torch.float32, 100 + bits)
        case(f"r4 C1024 bf16 int{bits}", "one_pass",
             quant_format(bits, True), 4, 1024, torch.bfloat16, 110 + bits)
    for (block, r, C), dtype, bits, stochastic, residual in \
            itertools.product(QUANT_EDGE_SHAPES, QUANT_DTYPES, (8, 4),
                              (True, False), (True, False)):
        seed += 1
        case(f"block {block} r{r} C{C} {dtype} int{bits} "
             f"{'stochastic' if stochastic else 'nearest'}"
             f"{' residual' if residual else ''}",
             "first" if block == 6 else "one_pass",
             quant_format(bits, stochastic, block), r, C, dtype, seed,
             residual=residual)
    for bits, dtype in itertools.product((8, 4), (torch.float32,
                                                  torch.bfloat16)):
        seed += 1  # rows one element off 16-byte alignment
        rows = quant_rows(1, 4352, dtype, seed).reshape(-1)[1:4097]
        case(f"misaligned {dtype} int{bits}", "first",
             quant_format(bits, True), 1, 4096, dtype, seed,
             rows=rows.view(1, 4096))
    log({"phase": "quant", "check": "quant_pack (both forms) and "
         "unpack_dequantize against their plain versions, bitwise, NaN "
         "and inf blocks included", "cases": len(cases),
         "cases_by_chosen_form": forms, "all_equal": True,
         "case_list": cases})
    # Timed at the embedding's bucket: bf16 (the hook path's gradients)
    # and f32, int8 stochastic with the residual; unpack with the row sum.
    try:
        sass = quant_pack_sass_ops(out_dir)
    except (OSError, subprocess.CalledProcessError, StopIteration,
            ValueError, AssertionError) as exc:
        sass = None
        log({"phase": "quant", "sass": f"not counted: {exc!r}"})
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, C in QUANT_SHAPES:
            timed[f"{label} {dtype}"] = quant_kernel_case(
                tq, quant_format(8, True), 1, C, dtype, 200, timing=True,
                sass=sass)
    log({"phase": "quant", "timing": "int8 stochastic, r = 1, residual "
         "out; quant_pack's two forms in turns (first, one pass, one pass, "
         "first); unpack with the row sum; bound = max(bytes / 3.35 TB/s, "
         "quant_pack's operations an element, max(ALU-only / 64, all / "
         "128 lanes) / (SMs x the SM clock under load))",
         "sass": None if sass is None else {
             form: {str(k): v for k, v in counts.items()}
             for form, counts in sass.items()},
         "device": smi_line, **timed})
    for label, row in timed.items():
        if row["quant_pack_ms"] >= row["quant_pack_first_form_ms"]:
            raise AssertionError(f"{label}: the one pass "
                                 f"({row['quant_pack_turns_ms']}) is not "
                                 f"faster than the first form")
    torch.cuda.empty_cache()

    # 2. A one-rank quantized allreduce through hvd.allreduce.
    hvd.init(device="cuda")
    log({"phase": "quant", "check": "one-rank hvd.allreduce, int8",
         **quant_one_rank_allreduce(hvd, qc, MK)})

    # 3. GPT-2-small through the hook path: none, int8, int4 from the
    # same init and batches, 3 steps each.
    cfg = transformer_lm.bench_config()
    batch, seq = 8, 1024

    def run_with(policy, steps):
        hvd.set_compression(default=policy, rules=QUANT_RULES) \
            if policy else hvd.set_compression()
        return transformer_lm.train(cfg, batch=batch, seq=seq, steps=steps,
                                    device="cuda", seed=0, hooks=True)

    losses = {}
    for policy in (None, "int8", "int4"):
        run = run_with(policy, 3)
        losses[policy or "none"] = run["losses"]
        del run
        torch.cuda.empty_cache()
    ref = losses["none"]
    for policy in ("int8", "int4"):
        got = losses[policy]
        if got[0] != ref[0]:
            raise AssertionError(f"{policy}: the first step's loss {got[0]} "
                                 f"is not the uncompressed {ref[0]}")
        if not all(np.isfinite(got)) or not got[-1] < got[0]:
            raise AssertionError(f"{policy}: losses not finite and falling: "
                                 f"{got}")
        if any(abs(a - b) > 0.02 * abs(b) for a, b in zip(got, ref)):
            raise AssertionError(f"{policy}: losses {got} beyond 2% of the "
                                 f"uncompressed {ref}")
    log({"phase": "quant", "check": "GPT-2-small hook path, 3 steps from "
         "the same init and batches", "losses": losses})

    # Timed in turns: none, int8, int8, none; 2 warm-up and 5 timed steps.
    warmup, steps = 2, 5
    turns = {"none": [], "int8": []}
    main_launches = None
    for policy in ("none", "int8", "int8", "none"):
        fa.reset_launches()
        tq.reset_launches()
        MK.reset_stats()
        run = run_with(None if policy == "none" else policy, warmup)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run["step"](run["params"], run["data"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        total = warmup + steps
        q_launches, stats = dict(tq.launches), MK.stats
        q_forms = dict(tq.form_launches)
        if policy == "int8" and main_launches is None:
            main_launches = q_launches
        if any(c != cfg.n_layers * total for c in fa.launches.values()):
            raise AssertionError(f"each flash kernel must launch "
                                 f"{cfg.n_layers} times a step: "
                                 f"{fa.launches}")
        buckets = stats.quant_launches
        if policy == "int8" and (buckets == 0 or any(
                c != 2 * buckets for c in q_launches.values())):
            raise AssertionError(f"int8: {q_launches} launches for "
                                 f"{buckets} quantized buckets, not 2 each")
        if policy == "int8" and (q_forms["first"] != 0 or q_forms[
                "one_pass"] != q_launches["quant_pack"]):
            raise AssertionError(f"int8: quant_pack launched {q_forms}, "
                                 f"not the one pass every time")
        if policy == "none" and any(q_launches.values()):
            raise AssertionError(f"uncompressed: {q_launches}")
        row = {"step_ms": seconds / steps * 1e3,
               "tokens_per_s": batch * seq * steps / seconds,
               "buckets_per_step": stats.launches / total,
               "quantized_buckets_per_step": buckets / total,
               "launches_per_step": {k: v / total
                                     for k, v in q_launches.items()},
               "quant_pack_form_launches_per_step": {
                   k: v / total for k, v in q_forms.items()},
               "logical_bytes_per_step": stats.logical_bytes / total,
               "wire_bytes_per_step": stats.wire_bytes / total}
        if policy == "int8" and "profile" not in turns:
            def one_step():
                run["step"](run["params"], run["data"])

            nbytes, pack_dtypes = record_quant_calls(tq, one_step)
            bound_ms = nbytes / PEAK_BYTES * 1e3
            prof = profile_step(one_step, out_dir, "quant")
            prof["quant_kernels"] = quant_trace_ms(
                os.path.join(out_dir, "quant_trace.json"))
            prof["quant_kernels_ms"] = sum(
                v["ms"] for v in prof["quant_kernels"].values())
            prof["quant_bound_ms"] = bound_ms
            prof["quant_pack_calls_by_dtype"] = pack_dtypes
            turns["profile"] = prof
        leaves = tree_leaves(run["params"])
        if any(t.device.type != "cuda" for t in leaves):
            raise AssertionError("a parameter is off the card")
        turns[policy].append(row)
        del run, leaves
        torch.cuda.empty_cache()
    for policy in ("none", "int8"):
        turns[f"{policy}_mean_step_ms"] = float(np.mean(
            [r["step_ms"] for r in turns[policy]]))
    log({"phase": "quant_trainer", "model": "GPT-2-small", "batch": batch,
         "seq": seq, "dtype": "bfloat16", "policy": "int8, LN and biases "
         "none", "device": smi_line, **turns})
    hvd.set_compression()
    hvd.shutdown()
    emb = timed["embedding torch.bfloat16"]
    return {"launches": main_launches, "result": emb}


def overlap_trace(trace_path):
    """In a profiled overlapped step: each quantized bucket's first codec
    kernel (quant_pack / unpack_dequantize, 2 + 2 a bucket, in launch
    order) against the last flash dQ kernel, ms after its end (negative:
    before it ended, under the backward)."""
    with open(trace_path) as f:
        events = sorted((e for e in json.load(f)["traceEvents"]
                         if e.get("ph") == "X" and e.get("cat") == "kernel"),
                        key=lambda e: e["ts"])
    dq = [e for e in events if "flash_bwd_dq_sm90_kernel" in e["name"]]
    codec = [e for e in events if any(
        pattern in e["name"] for pattern in QUANT_TRACE_NAMES.values())]
    if not dq or not codec or len(codec) % 4:
        raise AssertionError(f"profiled int8 overlapped step: {len(dq)} dQ "
                             f"kernels, {len(codec)} codec kernels")
    end = max(e["ts"] + e["dur"] for e in dq)
    starts = [(codec[i]["ts"] - end) / 1e3 for i in range(0, len(codec), 4)]
    return {"quantized_buckets": len(starts),
            "bucket_first_kernel_ms_after_last_dq": starts,
            "last_bucket_ms_after_last_dq": starts[-1],
            "buckets_started_before_last_dq_end": sum(x < 0 for x in starts)}


def phase_overlap(fa, smi_line, out_dir):
    """GPT-2-small as chained_lm_loss (embedding, 12 decoder-layer stages,
    head) through make_train_step's schedules off, serial and on (forced:
    auto is off on one card)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.native import lib as native
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.ops import megakernel as MK
    from horovod_tpu_torch.ops import quant as tq
    from horovod_tpu_torch.utils.tree import tree_leaves

    torch.cuda.empty_cache()
    cfg = transformer_lm.bench_config()
    batch, seq = 8, 1024
    hvd.init(device="cuda")

    def host_profile(step_fn, steps=3, top=25):
        """cProfile of ``steps`` steps: the top functions by own time, ms
        a step (cumulative, own)."""
        import cProfile
        import pstats

        prof = cProfile.Profile()
        torch.cuda.synchronize()
        prof.enable()
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
        prof.disable()
        rows = sorted(pstats.Stats(prof).stats.items(),
                      key=lambda kv: -kv[1][2])[:top]
        return [(f"{os.path.basename(fn)}:{line}({name})",
                 round(ct / steps * 1e3, 3), round(tt / steps * 1e3, 3),
                 nc // steps)
                for (fn, line, name), (nc, _pc, tt, ct, _c) in rows]

    def train(mode, steps, policy=None):
        # The policy looks a format up by tensor name, and the overlapped
        # step sends its buckets under their wire names: QUANT_RULES (the
        # hook path's LN and bias rules) would match none of them, so the
        # overlapped int8 step quantizes every bucket, LN and biases too.
        hvd.set_compression(default=policy)
        MK.flush("overlap phase run")  # each run from tick 0, no residual
        return transformer_lm.train(cfg, batch=batch, seq=seq, steps=steps,
                                    device="cuda", seed=0, overlap=mode)

    def three(mode, policy=None):
        run = train(mode, 3, policy)
        out = ([float(x) for x in run["losses"]],
               [p.detach().clone() for p in tree_leaves(run["params"])])
        del run
        torch.cuda.empty_cache()
        return out

    def same(a, b):
        return a[0] == b[0] and all(torch.equal(x, y)
                                    for x, y in zip(a[1], b[1]))

    # 1. Bitwise: off, serial, on from the same weights and batches;
    # under int8, on against serial.
    full = {mode: three(mode) for mode in ("off", "serial", "on")}
    if not (same(full["on"], full["serial"])
            and same(full["on"], full["off"])):
        raise AssertionError(f"overlap schedules differ: "
                             f"{ {m: r[0] for m, r in full.items()} }")
    losses = full["on"][0]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"overlap losses not finite and falling: "
                             f"{losses}")
    del full
    int8 = {mode: three(mode, "int8") for mode in ("serial", "on")}
    if not same(int8["on"], int8["serial"]):
        raise AssertionError(f"int8 on differs from serial: "
                             f"{int8['on'][0]} / {int8['serial'][0]}")
    int8_losses = int8["on"][0]
    del int8
    torch.cuda.empty_cache()
    log({"phase": "overlap", "check": "GPT-2-small as chained_lm_loss, 3 "
         "steps from the same weights: on == serial == off bitwise; int8 "
         "on == serial bitwise", "losses": losses,
         "int8_losses": int8_losses})

    # 2. Timed in turns, 2 warm-up and 5 timed steps each: step ms, one
    # fused response a bucket, each flash kernel 12 times a step.
    warmup, steps = 2, 5
    timed: dict = {"off": [], "serial": [], "on": [], "on_python": []}
    path_launches = None
    for turn in ("off", "serial", "on", "on_python", "on_python", "on",
                 "serial", "off"):
        # on_python: the on schedule with HVD_TPU_DISABLE_NATIVE=1.
        mode = turn.split("_")[0]
        if turn == "on_python" or os.environ.get(native.DISABLE_ENV):
            hvd.shutdown()
            if turn == "on_python":
                os.environ[native.DISABLE_ENV] = "1"
            else:
                os.environ.pop(native.DISABLE_ENV, None)
            hvd.init(device="cuda")
        fa.reset_launches()
        run = train(mode, warmup)
        step = run["step"]
        C.reset_stats()
        before = step.stats() if mode != "off" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(run["params"], run["data"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        stats, launches = C.stats(), dict(fa.launches)
        if any(c != cfg.n_layers * (warmup + steps)
               for c in launches.values()):
            raise AssertionError(f"overlap {mode}: each flash kernel must "
                                 f"launch {cfg.n_layers} times a step: "
                                 f"{launches}")
        if mode == "on" and path_launches is None:
            path_launches = launches
        row = {"step_ms": seconds / steps * 1e3,
               "tokens_per_s": batch * seq * steps / seconds,
               "responses_per_step": stats["responses"] / steps,
               "cache_misses_per_step": stats["cache_misses"] / steps}
        if mode != "off":
            after = step.stats()
            ex0 = before["overlap.exposed_comm_seconds"]
            ex1 = after["overlap.exposed_comm_seconds"]
            row.update(
                buckets_per_step=step.bucket_count,
                segments=step.segment_count,
                buckets_dispatched_per_step=(
                    after["overlap.buckets_dispatched"]
                    - before["overlap.buckets_dispatched"]) / steps,
                exposed_comm_ms_per_step=(ex1["sum"] - ex0["sum"])
                / steps * 1e3,
                fallbacks=after["overlap.fallbacks"])
            # One fused response a bucket (and one for the loss), every
            # request replayed from the cache.
            if stats["responses"] != steps * (step.bucket_count + 1) \
                    or stats["cache_misses"] != 0 \
                    or row["buckets_dispatched_per_step"] \
                    != step.bucket_count or not step.overlap_active:
                raise AssertionError(f"overlap {mode}: {stats} for "
                                     f"{step.bucket_count} buckets")
        timed[turn].append(row)
        if turn == "on" and "on_profile" not in timed:
            prof = profile_step(lambda: step(run["params"], run["data"]),
                                out_dir, "overlap")
            prof.update(executor_overlap(os.path.join(
                out_dir, "overlap_trace.json")))
            timed["on_profile"] = prof
            timed["on_host_profile"] = host_profile(
                lambda: step(run["params"], run["data"]))
        if turn == "off" and "off_host_profile" not in timed:
            timed["off_host_profile"] = host_profile(
                lambda: step(run["params"], run["data"]))
        del run, step
        torch.cuda.empty_cache()
    os.environ.pop(native.DISABLE_ENV, None)
    for turn in ("off", "serial", "on", "on_python"):
        timed[f"{turn}_mean_step_ms"] = float(np.mean(
            [r["step_ms"] for r in timed[turn]]))
    log({"phase": "overlap_trainer", "model": "GPT-2-small, chained",
         "batch": batch, "seq": seq, "dtype": "bfloat16",
         "device": smi_line, "flash_launches_on_path": path_launches,
         **timed})

    # 3. One profiled int8 on step: where each quantized bucket's codec
    # kernels start against the last dQ.
    fa.reset_launches()
    tq.reset_launches()
    run = train("on", warmup, "int8")
    q_launches, q_forms = dict(tq.launches), dict(tq.form_launches)
    if not all(q_launches.values()):
        raise AssertionError(f"int8 overlapped path: {q_launches}")
    if q_forms["first"] != 0 or q_forms["one_pass"] != \
            q_launches["quant_pack"]:
        raise AssertionError(f"int8 overlapped path: quant_pack launched "
                             f"{q_forms}, not the one pass every time")
    _, pack_dtypes = record_quant_calls(
        tq, lambda: run["step"](run["params"], run["data"]))
    prof = profile_step(lambda: run["step"](run["params"], run["data"]),
                        out_dir, "overlap_int8")
    prof["quant_pack_calls_by_dtype"] = pack_dtypes
    prof.update(overlap_trace(os.path.join(out_dir,
                                           "overlap_int8_trace.json")))
    log({"phase": "overlap_int8", "device": smi_line,
         "codec_launches_warmup": q_launches,
         "quant_pack_form_launches_warmup": q_forms,
         "buckets_per_step": run["step"].bucket_count, **prof})
    del run
    hvd.set_compression()
    hvd.shutdown()
    return path_launches


# parallel phase: the multi-axis step (ROADMAP A.3, first half).
# Remat against the plain step: the reference's remat tolerance
# (tests/test_transformer.py:162-166), or bitwise.
REMAT_RTOL, REMAT_ATOL = 1e-5, 1e-6
# MoE card against CPU (f32, TF32 off), relative to the largest magnitude
# of the value or leaf, as RESNET_TOL_*: the loss, each gradient leaf.
MOE_TOL_LOSS, MOE_TOL_GRAD = 1e-5, 1e-4


def flash_kernels_ms(fa, fn, repeats=3):
    """Device time of the flash kernels ``fn`` launches, by CUDA events
    around each launch, summed (the mean of ``repeats`` calls after one
    warm-up).  Each call is queued behind ~30 ms of spinning on the card,
    so the host runs ahead and no event pair spans a wait for the host."""
    real = {name: getattr(fa, name) for name in fa.KERNELS}
    spans = []

    def timed(kernel):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = kernel(*args)
            end.record()
            spans.append((start, end))
            return out
        return call

    fn()
    for name, kernel in real.items():
        setattr(fa, name, timed(kernel))
    try:
        for _ in range(repeats):
            torch.cuda._sleep(50_000_000)
            fn()
    finally:
        for name, kernel in real.items():
            setattr(fa, name, kernel)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / repeats


def adamw_allowed(lr, steps):
    """Per-element allowance between two AdamW runs whose gradients
    differ only in rounding: an update m/(sqrt(v)+eps) is at most ~1 in
    magnitude in the first steps, so a gradient near zero that changes
    sign moves the weight by up to 2 lr a step; plus the bf16 allowance
    of the weight itself."""
    return lambda want: 2 * lr * steps + bf16_allowed(want)


def phase_parallel(fa, smi_line, out_dir):
    """make_parallel_train_step on a one-rank mesh (data x seq x model),
    a ring of 4 played in one process at s8192, Ulysses on one rank, and
    an MoE transformer."""
    import dataclasses

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.topology import make_mesh
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import fused
    from horovod_tpu_torch.parallel import sequence as sp
    from horovod_tpu_torch.parallel.training import make_parallel_train_step
    from horovod_tpu_torch.utils.tree import tree_leaves, tree_named_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = transformer_lm.bench_config()
    batch, seq, lr, warmup, steps = 8, 1024, 3e-4, 2, 5
    hvd.init(device="cuda")
    mesh = make_mesh(data=1, seq=1, model=1)
    ax = tt.ParallelAxes(data="data", seq="seq", model="model")
    spec = ("data", "seq")

    def lm_batch(b, device="cuda"):
        tokens, targets = tt.synthetic_lm_batch(
            torch.Generator().manual_seed(1), b, seq, cfg.vocab_size)
        return tokens.to(device), targets.to(device)

    data = lm_batch(batch)

    def set_fuse(mode):
        if mode is None:
            os.environ.pop(fused.FUSE_ENV, None)
        else:
            os.environ[fused.FUSE_ENV] = mode

    def parallel(n, fuse=None, c=cfg, axes=ax, b=data):
        """A model and AdamW(3e-4) from seed 0 (the trainer's), n steps of
        make_parallel_train_step on the global batch b."""
        set_fuse(fuse)
        params = tt.init_transformer(torch.Generator().manual_seed(0), c,
                                     device="cuda")
        opt = torch.optim.AdamW(tree_leaves(params), lr=lr,
                                weight_decay=1e-4)
        step = make_parallel_train_step(tt.make_loss_fn(c, axes, mesh), opt,
                                        mesh, spec)
        losses = [step(params, b) for _ in range(n)]
        return {"losses": [float(x) for x in losses], "params": params,
                "step": lambda: step(params, b)}

    def monolithic(n, timed_from=0):
        return transformer_lm.train(cfg, batch=batch, seq=seq, steps=n,
                                    timed_from=timed_from, device="cuda",
                                    seed=0)

    def leaves(run):
        return [p.detach().clone() for p in tree_leaves(run["params"])]

    def bitwise(a_losses, a_leaves, b_losses, b_leaves):
        return a_losses == b_losses and all(
            torch.equal(x, y) for x, y in zip(a_leaves, b_leaves))

    def per_step(launches, n):
        return {k: v / n for k, v in launches.items()}

    # 1. The main path: 3 steps, HVD_TPU_FUSE=off bitwise the monolithic
    # make_train_step; fusion on (the default) reported.
    mono = monolithic(3)
    mono_losses, mono_leaves = mono["losses"], leaves(mono)
    del mono
    fa.reset_launches()
    off = parallel(3, "off")
    off_launches = dict(fa.launches)
    if any(v != 3 * cfg.n_layers for v in off_launches.values()):
        raise AssertionError(f"parallel step: each flash kernel must launch "
                             f"{cfg.n_layers} times a step: {off_launches}")
    off_losses, off_leaves = off["losses"], leaves(off)
    del off
    if not bitwise(off_losses, off_leaves, mono_losses, mono_leaves):
        raise AssertionError(f"HVD_TPU_FUSE=off: the parallel step differs "
                             f"from the monolithic one: {off_losses} / "
                             f"{mono_losses}")
    if not all(np.isfinite(off_losses)) or not off_losses[-1] < off_losses[0]:
        raise AssertionError(f"parallel losses not finite and falling: "
                             f"{off_losses}")
    torch.cuda.empty_cache()
    on = parallel(3)
    on_losses, on_leaves = on["losses"], leaves(on)
    del on
    on_bitwise = bitwise(on_losses, on_leaves, mono_losses, mono_leaves)
    fused_row = {"bitwise": on_bitwise, "losses": on_losses,
                 "chunks": fused.fuse_chunks(),
                 "chunk_rows": [size * seq for _, size in
                                fused.plan_chunks(batch)]}
    if not on_bitwise:
        # Hold the first step's gradients (fused against unfused, the same
        # weights and batch) within the kernel phase's bf16 allowance, and
        # the weights after 3 steps within AdamW's bound of it.
        def grads(mode):
            set_fuse(mode)
            params = tt.init_transformer(torch.Generator().manual_seed(0),
                                         cfg, device="cuda")
            loss = tt.make_loss_fn(cfg, ax, mesh)(params, data)
            loss.backward()
            return float(loss.detach()), {n: p.grad for n, p in
                                          tree_named_leaves(params)}

        l_off, g_off = grads("off")
        l_on, g_on = grads(None)
        fused_row["first_loss_bitwise"] = l_on == l_off
        fused_row["grad_worst_ratio"] = max(
            check(f"fused grad {n}", g_on[n], g_off[n], bf16_allowed)[1]
            for n in g_off)
        fused_row["grads_bitwise"] = all(torch.equal(g_on[n], g_off[n])
                                         for n in g_off)
        del g_on, g_off
        fused_row["param_max_abs_diff"] = max(
            float((x.float() - y.float()).abs().max())
            for x, y in zip(on_leaves, off_leaves))
        fused_row["param_worst_ratio"] = max(
            check("fused params", x, y, adamw_allowed(lr, 3))[1]
            for x, y in zip(on_leaves, off_leaves))
        fused_row["loss_max_rel_diff"] = max(
            abs(a - b) / abs(b) for a, b in zip(on_losses, off_losses))
        if not fused_row["loss_max_rel_diff"] <= RTOL_BF16:
            raise AssertionError(f"fused losses: {fused_row}")
    del on_leaves, off_leaves, mono_leaves
    torch.cuda.empty_cache()

    # Remat: the same 3 steps with every layer recomputed in the backward;
    # each run's peak memory above what was allocated before it.
    def peak_gb(fn):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run = fn()
        return run, (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    fa.reset_launches()
    remat, peak_remat = peak_gb(
        lambda: parallel(3, c=dataclasses.replace(cfg, remat=True)))
    remat_launches = per_step(dict(fa.launches), 3)
    remat_losses, remat_leaves = remat["losses"], leaves(remat)
    del remat
    if remat_launches != {"flash_fwd": 2 * cfg.n_layers,
                          "flash_bwd_dkdv": cfg.n_layers,
                          "flash_bwd_dq": cfg.n_layers}:
        raise AssertionError(f"remat launches a step: {remat_launches}")
    on, peak_plain = peak_gb(lambda: parallel(3))
    plain_leaves = leaves(on)
    del on
    remat_bitwise = bitwise(remat_losses, remat_leaves, on_losses,
                            plain_leaves)
    remat_err = max(float(((x.float() - y.float()).abs() - REMAT_RTOL
                           * y.float().abs()).max())
                    for x, y in zip(remat_leaves, plain_leaves))
    if not remat_bitwise and not (
            remat_err <= REMAT_ATOL and np.allclose(
                remat_losses, on_losses, rtol=REMAT_RTOL, atol=0)):
        raise AssertionError(f"remat differs: losses {remat_losses} / "
                             f"{on_losses}, excess {remat_err}")
    del remat_leaves, plain_leaves
    torch.cuda.empty_cache()
    log({"phase": "parallel", "check": "make_parallel_train_step on a "
         "one-rank data x seq x model mesh against make_train_step, 3 "
         "AdamW steps from the same weights and batches",
         "device": smi_line, "fuse_off_bitwise": True,
         "losses": off_losses, "fused": fused_row,
         "flash_launches_per_step": per_step(off_launches, 3),
         "remat": {"bitwise": remat_bitwise, "losses": remat_losses,
                   "launches_per_step": remat_launches,
                   "peak_mem_gb": peak_remat},
         "peak_mem_gb": peak_plain})

    # Timed in turns (parallel, monolithic, parallel with HVD_TPU_FUSE=off
    # twice, monolithic, parallel; 2 warm-up and 5 timed steps each): step
    # ms, and the host's enqueue ms a step (before the closing
    # synchronize), which shows whether the host holds the card back.
    timed: dict = {"parallel": [], "monolithic": [], "parallel_unfused": []}
    path_launches = None
    for turn in ("parallel", "monolithic", "parallel_unfused",
                 "parallel_unfused", "monolithic", "parallel"):
        fa.reset_launches()
        if turn == "monolithic":
            run = monolithic(warmup)
            step_fn = functools.partial(run["step"], run["params"],
                                        run["data"])
        else:
            run = parallel(warmup, "off" if turn == "parallel_unfused"
                           else None)
            step_fn = run["step"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        enqueued = time.perf_counter() - t0
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(fa.launches)
        if any(v != cfg.n_layers * (warmup + steps)
               for v in launches.values()):
            raise AssertionError(f"{turn}: flash launches {launches}")
        if turn == "parallel" and path_launches is None:
            path_launches = launches
        timed[turn].append({"step_ms": seconds / steps * 1e3,
                            "enqueue_ms": enqueued / steps * 1e3,
                            "tokens_per_s": batch * seq * steps / seconds})
        if turn == "parallel" and "parallel_profile" not in timed:
            timed["parallel_profile"] = profile_step(step_fn, out_dir,
                                                     "parallel")
        del run, step_fn
        torch.cuda.empty_cache()
    set_fuse(None)
    for turn in ("parallel", "monolithic", "parallel_unfused"):
        timed[f"{turn}_mean_step_ms"] = float(np.mean(
            [r["step_ms"] for r in timed[turn]]))
    log({"phase": "parallel_trainer", "model": "GPT-2-small",
         "batch": batch, "seq": seq, "dtype": "bfloat16",
         "mesh": "data 1 x seq 1 x model 1", "fuse": "default (on)",
         "device": smi_line, **timed})

    # 2. A ring of 4 played in one process (sequence.play_ring: the hop
    # functions ring_attention runs) at b1 h12 s8192 d64 bf16, against
    # flash attention over the whole sequence; Ulysses on one rank.
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, g = (torch.randn(1, 12, 8192, 64, generator=gen, device="cuda",
                              dtype=torch.float32).bfloat16()
                  for _ in range(4))
    ring_rows = {}
    for causal in (True, False):
        tag = "causal" if causal else "noncausal"
        fa.reset_launches()
        o, dq, dk, dv = sp.play_ring(q, k, v, g, 4, causal=causal)
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        want_n = 10 if causal else 16
        if launches != {name: want_n for name in fa.KERNELS}:
            raise AssertionError(f"ring of 4 ({tag}): launches {launches}, "
                                 f"not {want_n} of each")

        def whole():
            leaves_ = [t.detach().requires_grad_(True) for t in (q, k, v)]
            ow = fa.flash_attention(*leaves_, causal=causal)
            ow.backward(g)
            return [ow.detach()] + [t.grad for t in leaves_]

        errs = {name: check(f"ring {tag} {name}", got, want, bf16_allowed)
                for name, got, want in zip(("o", "dq", "dk", "dv"),
                                           (o, dq, dk, dv), whole())}
        del o, dq, dk, dv
        ring_rows[tag] = {
            "launches": launches,
            "max_abs_err": {n: e[0] for n, e in errs.items()},
            "worst_ratio": max(e[1] for e in errs.values()),
            "hops_flash_kernels_ms": flash_kernels_ms(
                fa, lambda: sp.play_ring(q, k, v, g, 4, causal=causal)),
            "whole_flash_kernels_ms": flash_kernels_ms(fa, whole),
            "ring_ms": cuda_time_ms(lambda: sp.play_ring(
                q, k, v, g, 4, causal=causal), iters=3, warmup=1),
            "whole_ms": cuda_time_ms(whole, iters=3, warmup=1)}
    seq_axis = mesh.axis("seq")
    uly, ref = [], []
    for fn, out in ((lambda *t: sp.ulysses_attention(
            *t, axis=seq_axis, causal=True), uly),
            (lambda *t: fa.flash_attention(*t, causal=True), ref)):
        leaves_ = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves_)
        o.backward(g)
        out.extend([o.detach()] + [t.grad for t in leaves_])
    ulysses_bitwise = all(torch.equal(a, b) for a, b in zip(uly, ref))
    if not ulysses_bitwise:
        raise AssertionError("ulysses_attention over one rank differs from "
                             "flash_attention")
    del q, k, v, g, uly, ref
    torch.cuda.empty_cache()
    log({"phase": "parallel_ring", "shape": "b1 h12 s8192 d64 bf16, four "
         "chunks of 2048", "device": smi_line, **ring_rows,
         "ulysses_one_rank_bitwise_flash": ulysses_bitwise})

    # 3. MoE: 8 experts, top-2, capacity factor 2, the experts on the data
    # axis of the one-rank mesh (all local), batch 2.
    moe_cfg = dataclasses.replace(cfg, num_experts=8, top_k=2,
                                  capacity_factor=2.0)
    moe_ax = tt.ParallelAxes(data="data", expert="data")
    moe_data = lm_batch(2)
    records = []
    real_moe = tt.moe_layer

    def recording(x, params, **kw):
        out = real_moe(x, params, **kw)
        with torch.no_grad():
            probs = torch.softmax(x.float() @ params["router"].float(), -1)
        records.append({"aux": out.aux_loss.detach(),
                        "dropped": out.dropped_fraction.detach(),
                        "probs": probs.cpu()})
        return out

    tt.moe_layer = recording
    try:
        fa.reset_launches()
        moe = parallel(3, c=moe_cfg, axes=moe_ax, b=moe_data)
        moe_launches = per_step(dict(fa.launches), 3)
        moe_stats = [(float(r["aux"]), float(r["dropped"])) for r in records]
        records.clear()
    finally:
        tt.moe_layer = real_moe
    moe_losses = moe["losses"]
    if not all(np.isfinite(moe_losses)) or not moe_losses[-1] < moe_losses[0]:
        raise AssertionError(f"MoE losses not finite and falling: "
                             f"{moe_losses}")
    if not all(aux > 0 for aux, _ in moe_stats):
        raise AssertionError(f"MoE aux losses: {moe_stats}")
    if any(c != moe_cfg.n_layers for c in moe_launches.values()):
        raise AssertionError(f"MoE flash launches a step: {moe_launches}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        moe["step"]()
    torch.cuda.synchronize()
    moe_ms = (time.perf_counter() - t0) / steps * 1e3
    del moe
    torch.cuda.empty_cache()

    # The card against the port on the CPU: f32, 2 layers, one forward
    # and backward from the same weights and batch.
    small = dataclasses.replace(moe_cfg, n_layers=2, dtype=torch.float32)
    tt.moe_layer = recording
    try:
        results = {}
        for device, m in (("cuda", mesh), ("cpu", None)):
            params = tt.init_transformer(torch.Generator().manual_seed(0),
                                         small, device=device)
            loss = tt.make_loss_fn(small, moe_ax, m)(
                params, tuple(x.to(device) for x in moe_data))
            loss.backward()
            results[device] = (loss.detach(), {
                n: p.grad for n, p in tree_named_leaves(params)},
                [r["probs"] for r in records])
            records.clear()
    finally:
        tt.moe_layer = real_moe
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = (results["cuda"],
                                                    results["cpu"])
    rounding = max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu))
    near_ties = routed_apart = 0
    for a, b in zip(p_gpu, p_cpu):
        top = b.topk(3, dim=-1).values
        gaps = top[:, :-1] - top[:, 1:]
        near_ties += int((gaps <= 2 * rounding).any(dim=-1).sum())
        routed_apart += int((a.topk(2, dim=-1).indices.sort(-1).values
                             != b.topk(2, dim=-1).indices.sort(-1).values)
                            .any(dim=-1).sum())
    loss_err = _rel_err(l_gpu, l_cpu)
    grad_errs = {n: _rel_err(g_gpu[n], g_cpu[n]) for n in g_cpu}
    moe_row = {"losses": moe_losses, "step_ms": moe_ms,
               "aux_per_layer_first_step": [
                   a for a, _ in moe_stats[:moe_cfg.n_layers]],
               "dropped_fraction_mean": float(np.mean(
                   [d for _, d in moe_stats])),
               "dropped_fraction_max": max(d for _, d in moe_stats),
               "flash_launches_per_step": moe_launches,
               "card_vs_cpu": {"loss_rel_err": loss_err,
                               "grad_rel_err_max": max(grad_errs.values()),
                               "grad_rel_err": grad_errs,
                               "router_prob_max_diff": rounding,
                               "near_ties": near_ties,
                               "tokens_routed_apart": routed_apart}}
    exposed = parallel_exposed_comm(mesh, cfg, batch * seq)
    log({"phase": "parallel_fused_exposed", "device": smi_line, **exposed})
    log({"phase": "parallel_moe", "model": "GPT-2-small widths, 8 experts "
         "top-2, capacity factor 2.0, 12 layers, batch 2, seq 1024, bf16",
         "device": smi_line, **moe_row})
    if not loss_err <= MOE_TOL_LOSS or not all(
            e <= MOE_TOL_GRAD for e in grad_errs.values()):
        raise AssertionError(f"MoE card against CPU: loss {loss_err}, "
                             f"grads {grad_errs}")
    set_fuse(None)
    hvd.shutdown()
    return path_launches


def parallel_exposed_comm(mesh, cfg, rows):
    """ops/fused.py measure_exposed_comm on the fused step's row-parallel
    closer (FFN-out, matmul_psum over the model axis, chunked) against
    the same chunks with the psum legs left out: >= 0 and observed in
    fused.exposed_comm_seconds."""
    import horovod_tpu_torch.telemetry as telemetry
    from horovod_tpu_torch.ops import fused

    g = torch.Generator().manual_seed(5)
    x = torch.randn(rows, cfg.d_ff, generator=g).cuda().bfloat16()
    w = (torch.randn(cfg.d_ff, cfg.d_model, generator=g)
         * cfg.d_ff ** -0.5).cuda().bfloat16()
    axis = mesh.axis("model")
    hist = telemetry.registry().histogram("fused.exposed_comm_seconds")
    before = hist.snapshot()["count"]
    exposed = fused.measure_exposed_comm(
        lambda a, b: fused.matmul_psum(a, b, axis=axis, fuse=True),
        lambda a, b: fused.chunked_map(lambda xc: fused._f32_matmul(xc, b),
                                       a, fuse=True), (x, w), cycles=5)
    if not exposed >= 0.0 or hist.snapshot()["count"] != before + 1:
        raise AssertionError(f"measure_exposed_comm: {exposed}")
    return {"closer": f"matmul_psum [{rows},{cfg.d_ff}]@[{cfg.d_ff},"
                      f"{cfg.d_model}], model axis of 1",
            "chunks": fused.fuse_chunks(), "exposed_comm_seconds": exposed}


# sharded phase: ZeRO-1 and FSDP (ROADMAP A.3, second half (a)).
SHARDS = 4  # the flat AdamW update split as 4 ranks would hold it


def optimizer_state_bytes(optimizer) -> int:
    """Bytes of every tensor in a torch optimizer's state."""
    return sum(v.numel() * v.element_size()
               for st in optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor))


def phase_sharded(fa, smi_line, out_dir):
    """GPT-2-small through make_zero_train_step and make_fsdp_train_step
    against make_train_step on one rank; the flat AdamW update as 4
    shards against one; ResNet-50 through Trainer(zero=True) and
    Trainer(fsdp=True) against Trainer()."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.frontends.loop import Trainer
    from horovod_tpu_torch.models import resnet as R
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel.fsdp import make_fsdp_train_step
    from horovod_tpu_torch.parallel.zero import (FlatLayout,
                                                 make_zero_train_step)
    from horovod_tpu_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = transformer_lm.bench_config()
    batch, seq, lr, warmup, steps = 8, 1024, 3e-4, 2, 5
    hvd.init(device="cuda")
    tokens, targets = tt.synthetic_lm_batch(
        torch.Generator().manual_seed(1), batch, seq, cfg.vocab_size)
    data = (tokens.cuda(), targets.cuda())
    loss_fn = tt.make_loss_fn(cfg)

    def adamw(leaves):
        # optax.adamw's weight decay; the for-each form on every side, so
        # that the sharded and the monolithic updates are one arithmetic.
        return torch.optim.AdamW(leaves, lr=lr, weight_decay=1e-4,
                                 foreach=True)

    def build(kind):
        """GPT-2-small from seed 0 (the trainer's weights) and AdamW:
        {"step": () -> loss, "leaves": () -> weights, "optimizer"}."""
        params = tt.init_transformer(torch.Generator().manual_seed(0), cfg,
                                     device="cuda")
        if kind == "monolithic":
            opt = hvd.DistributedOptimizer(adamw(tree_leaves(params)))
            step = hvd.make_train_step(loss_fn, opt)
            return {"step": lambda: step(params, data), "optimizer": opt,
                    "leaves": lambda: tree_leaves(params)}
        if kind == "zero":
            zstep = make_zero_train_step(loss_fn, adamw)
            held = {"opt": zstep.init(params)}

            def zero_step():
                _, held["opt"], loss = zstep.step(params, held["opt"], data)
                return loss

            return {"step": zero_step, "optimizer": held["opt"].optimizer,
                    "leaves": lambda: tree_leaves(params)}
        fstep = make_fsdp_train_step(loss_fn, adamw)
        p_shard, opt = fstep.init(params)
        del params
        held = {"p": p_shard, "opt": opt}

        def fsdp_step():
            held["p"], held["opt"], loss = fstep.step(held["p"], held["opt"],
                                                      data)
            return loss

        return {"step": fsdp_step, "optimizer": opt.optimizer,
                "leaves": lambda: tree_leaves(fstep.full_params(held["p"]))}

    # 1. Three steps of each from the same weights and batch: losses and
    # weights bitwise the monolithic step's (one rank: the reduce-scatter
    # and the all-gather are copies, and AdamW is elementwise), or within
    # AdamW's bound; 12 launches of each flash kernel a step.
    runs = {}
    for kind in ("monolithic", "zero", "fsdp"):
        fa.reset_launches()
        run = build(kind)
        losses = [float(run["step"]()) for _ in range(3)]
        launches = {k: v / 3 for k, v in fa.launches.items()}
        if any(v != cfg.n_layers for v in launches.values()):
            raise AssertionError(f"{kind}: flash launches a step "
                                 f"{launches}, not {cfg.n_layers}")
        runs[kind] = {"losses": losses, "launches_per_step": launches,
                      "leaves": [p.detach().clone() for p in run["leaves"]()]}
        del run
        torch.cuda.empty_cache()
    mono = runs["monolithic"]
    if not all(np.isfinite(mono["losses"])) or not (
            mono["losses"][-1] < mono["losses"][0]):
        raise AssertionError(f"monolithic losses: {mono['losses']}")
    rows = {}
    for kind in ("zero", "fsdp"):
        r = runs[kind]
        bitwise = r["losses"] == mono["losses"] and all(
            torch.equal(a, b) for a, b in zip(r["leaves"], mono["leaves"]))
        row = {"bitwise": bitwise, "losses": r["losses"],
               "launches_per_step": r["launches_per_step"]}
        if not bitwise:
            row["held"] = "adamw_allowed"
            row["param_worst_ratio"] = max(
                check(f"{kind} params", a, b, adamw_allowed(lr, 3))[1]
                for a, b in zip(r["leaves"], mono["leaves"]))
            row["loss_max_rel_diff"] = max(
                abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                    mono["losses"]))
            if not row["loss_max_rel_diff"] <= RTOL_BF16:
                raise AssertionError(f"{kind} losses: {row}")
        rows[kind] = row
    del runs, r
    torch.cuda.empty_cache()

    # 2. The flat AdamW update as SHARDS shards, each with its own AdamW,
    # against one: GPT-2-small's weights and a 3-element leaf (136,137,219
    # elements, not a multiple of 4, so the last shard is padded), three
    # steps of seeded gradients; the concatenation must be bitwise.
    def four_shards():
        params = tt.init_transformer(torch.Generator().manual_seed(0), cfg,
                                     device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(7)
        tree = {"gpt2": params, "extra": torch.randn(
            3, generator=gen, device="cuda").to(cfg.dtype)}
        layout = FlatLayout(tree, SHARDS)
        one = FlatLayout(tree, 1).flatten(tree_leaves(tree))
        one.requires_grad_(True)
        flat, c = layout.flatten(tree_leaves(tree)), layout.chunk
        shards = [flat[i * c:(i + 1) * c].clone().requires_grad_(True)
                  for i in range(SHARDS)]
        opts = [adamw([s]) for s in shards]
        opt_one = adamw([one])
        for _ in range(3):
            g = (torch.randn(layout.true_size, generator=gen, device="cuda")
                 * 1e-2).to(cfg.dtype)
            one.grad = g
            opt_one.step()
            padded = torch.cat([g, g.new_zeros(SHARDS * c - g.numel())])
            for i, (s, o) in enumerate(zip(shards, opts)):
                s.grad = padded[i * c:(i + 1) * c].clone()
                o.step()
        joined = torch.cat([s.detach() for s in shards])
        return {"true_size": layout.true_size, "padded": SHARDS * c,
                "chunk": c,
                "bitwise": bool(torch.equal(joined[:layout.true_size],
                                            one.detach())),
                "padding_zero": not bool(joined[layout.true_size:].any())}

    shard_row = four_shards()
    torch.cuda.empty_cache()
    if not shard_row["bitwise"] or not shard_row["padding_zero"]:
        raise AssertionError(f"{SHARDS}-shard AdamW update: {shard_row}")
    log({"phase": "sharded", "check": "GPT-2-small through "
         "make_zero_train_step and make_fsdp_train_step against "
         "make_train_step, 3 AdamW(3e-4, foreach) steps from the same "
         "weights and batch; the flat update as 4 shards against one",
         "device": smi_line, "monolithic_losses": mono["losses"], **rows,
         "four_shards": shard_row})
    del mono

    # 3. Timed in turns (monolithic, zero, fsdp, fsdp, zero, monolithic; 2
    # warm-up and 5 timed steps each): step ms, the host's enqueue ms a
    # step, the memory the path holds between steps and its peak during
    # them (both above what was allocated before it was built), and the
    # optimizer-state bytes this rank holds.
    timed = {k: [] for k in ("monolithic", "zero", "fsdp")}
    path_launches = {}
    for turn in ("monolithic", "zero", "fsdp", "fsdp", "zero", "monolithic"):
        gc.collect()  # cyclic garbage of the last turn, if any
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        fa.reset_launches()
        run = build(turn)
        for _ in range(warmup):
            run["step"]()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            run["step"]()
        enqueued = time.perf_counter() - t0
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(fa.launches)
        if any(v != cfg.n_layers * (warmup + steps)
               for v in launches.values()):
            raise AssertionError(f"{turn}: flash launches {launches}")
        path_launches.setdefault(turn, launches)
        timed[turn].append({
            "step_ms": seconds / steps * 1e3,
            "enqueue_ms": enqueued / steps * 1e3,
            "tokens_per_s": batch * seq * steps / seconds,
            "resident_gb": (resident - base) / 2 ** 30,
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
            "optimizer_state_bytes": optimizer_state_bytes(
                run["optimizer"])})
        if turn != "monolithic" and f"{turn}_profile" not in timed:
            timed[f"{turn}_profile"] = profile_step(run["step"], out_dir,
                                                    f"sharded_{turn}")
        del run
    for turn in ("monolithic", "zero", "fsdp"):
        timed[f"{turn}_mean_step_ms"] = float(np.mean(
            [r["step_ms"] for r in timed[turn]]))
    log({"phase": "sharded_trainer", "model": "GPT-2-small",
         "batch": batch, "seq": seq, "dtype": "bfloat16", "ranks": 1,
         "device": smi_line, **timed})
    torch.cuda.empty_cache()

    # 4. ResNet-50 at bench.py's recipe (space-to-depth stem, 224 px,
    # batch 128, bf16 compute, SGD(0.1, momentum 0.9)) through Trainer,
    # Trainer(zero=True) and Trainer(fsdp=True) with the broadcast
    # callback, 3 steps on one fixed batch each; cuDNN's deterministic
    # algorithms, so that two runs of one tree are comparable bit for bit.
    cudnn = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    model = R.ResNet50(num_classes=1000, space_to_depth=True)
    images, labels = R.synthetic_imagenet(128, image_size=224,
                                          num_classes=1000)
    fixed = (images, labels)
    resnet = {}
    try:
        for mode in ("plain", "zero", "fsdp"):
            params, stats = R.init_resnet(model, seed=0, device="cuda")
            trainer = Trainer(
                R.resnet_loss_fn(model), params, lr=0.1,
                optimizer_kwargs={"momentum": 0.9}, model_state=stats,
                callbacks=[callbacks.BroadcastGlobalVariablesCallback(0)],
                **({} if mode == "plain" else {mode: True}))
            del params
            losses = []

            class Losses(callbacks.Callback):
                def on_batch_end(self, step, logs=None):
                    losses.append(logs["loss"])

            trainer.callbacks.append(Losses())
            trainer.fit(lambda e, s: fixed, epochs=1, steps_per_epoch=3,
                        prefetch=0, log_every=1)
            resnet[mode] = {
                "losses": losses,
                "params": [p.detach().clone()
                           for p in tree_leaves(trainer.params)],
                "stats": [s.detach().clone()
                          for s in tree_leaves(trainer.model_state)],
                "optimizer_state_bytes": optimizer_state_bytes(
                    trainer.optimizer)}
            del trainer
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = cudnn
    plain = resnet["plain"]
    p0 = tree_leaves(R.init_resnet(model, seed=0)[0])
    resnet_rows = {}
    for mode in ("zero", "fsdp"):
        r = resnet[mode]
        bitwise = r["losses"] == plain["losses"] and all(
            torch.equal(a, b) for a, b in zip(r["params"] + r["stats"],
                                              plain["params"]
                                              + plain["stats"]))
        row = {"bitwise": bitwise, "losses": r["losses"],
               "optimizer_state_bytes": r["optimizer_state_bytes"]}
        if not bitwise:
            # The bound: each leaf's update p3 - p0 against the plain
            # run's, relative to its largest magnitude, within
            # RESNET_TOL_UPDATE (the card-against-CPU bound of one step's
            # gradient rounding; the momentum sum weights each step's
            # gradient and its rounding alike, so three steps keep the
            # same relative bound); the losses and statistics within
            # RESNET_TOL_LOSS and RESNET_TOL_STATE.
            row["held"] = "RESNET_TOL_UPDATE"
            row["update_rel_err"] = max(
                _rel_err(a.cpu() - q, b.cpu() - q)
                for a, b, q in zip(r["params"], plain["params"], p0))
            row["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in
                                      zip(r["losses"], plain["losses"]))
            row["state_rel_err"] = max(_rel_err(a, b) for a, b in
                                       zip(r["stats"], plain["stats"]))
            if not (row["update_rel_err"] <= RESNET_TOL_UPDATE
                    and row["loss_rel_err"] <= RESNET_TOL_LOSS
                    and row["state_rel_err"] <= RESNET_TOL_STATE):
                raise AssertionError(f"ResNet-50 {mode}: {row}")
        resnet_rows[mode] = row
    log({"phase": "sharded_resnet", "model": "ResNet-50 space-to-depth, "
         "224 px, batch 128, bf16, SGD(0.1, 0.9), Trainer with "
         "BroadcastGlobalVariablesCallback, 3 steps", "device": smi_line,
         "plain_losses": plain["losses"],
         "plain_optimizer_state_bytes": plain["optimizer_state_bytes"],
         **resnet_rows})
    del resnet, plain, p0
    torch.cuda.empty_cache()
    hvd.shutdown()
    return path_launches


# pipeline phase: GPT-2-small as a 14-stage pipeline (ROADMAP A.3, second
# half (b)).
PIPE_MICROBATCHES = 8
# First-step gradients of the pipeline against the monolithic step's: each
# stage's gradient is 8 microbatch gradients, each rounded to bf16, summed
# in bf16 in 7 more roundings, where the monolithic backward rounds each
# weight's gradient once.  Up to 15 roundings of partial sums against one:
# the per-element allowance is this multiple of the kernel phase's bf16
# allowance.  The played pipeline's weight gradients are sums over its
# ticks in bf16 in the same way.
PIPE_GRAD_ALLOWANCE = 4.0


class _CaptureGrads(torch.optim.Optimizer):
    """An optimizer that keeps a copy of each parameter's gradient and
    leaves the parameter alone: the pipeline step's reduced, divided
    gradients of one step."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = []

    @torch.no_grad()
    def step(self, closure=None):
        self.grads = [p.grad.detach().clone() for g in self.param_groups
                      for p in g["params"]]


def pipeline_series_equal_stats(before: dict, st: dict, turn: str) -> None:
    """The registry's pipeline.* series (ROADMAP A.5.1) moved by exactly
    what one pipeline step object's stats() holds: the counter and the
    histogram's count by its values, the histogram's sum by its sum (to
    float rounding of the running total), the gauges equal."""
    import horovod_tpu_torch.telemetry as telemetry

    now = telemetry.registry().snapshot(run_collectors=False)

    def value(snap, name, key="value"):
        return snap.get(name, {}).get(key, 0)

    b = st["pipeline.bubble_seconds"]
    ok = (value(now, "pipeline.microbatches")
          - value(before, "pipeline.microbatches")
          == st["pipeline.microbatches"]
          and value(now, "pipeline.bubble_seconds", "count")
          - value(before, "pipeline.bubble_seconds", "count") == b["count"]
          and abs(value(now, "pipeline.bubble_seconds", "sum")
                  - value(before, "pipeline.bubble_seconds", "sum")
                  - b["sum"]) <= 1e-9 * max(1.0, b["sum"])
          and value(now, "pipeline.inflight_activations")
          == st["pipeline.inflight_activations"]
          and value(now, "pipeline.inflight_activation_bytes")
          == st["pipeline.inflight_activation_bytes"])
    if not ok:
        raise AssertionError(f"{turn}: pipeline.* series "
                             f"{ {k: v for k, v in now.items() if k.startswith('pipeline.')} } "
                             f"against stats() {st}")


def phase_pipeline(fa, smi_line, out_dir):
    """GPT-2-small as chained_lm_loss (embedding, 12 layer stages, head)
    through make_pipeline_train_step under GPipe, 1F1B and interleaved
    1F1B against make_train_step; the three kernels at the microbatch's
    shape; gpipe through ParallelAxes(data, pipe); a played pipeline of
    4 stages."""
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.telemetry as telemetry
    from horovod_tpu_torch.core.topology import make_mesh
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import pipeline as PL
    from horovod_tpu_torch.parallel.training import make_parallel_train_step
    from horovod_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                              tree_map, tree_unflatten)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = transformer_lm.bench_config()
    batch, seq, lr, warmup, steps = 8, 1024, 3e-4, 2, 5
    m = PIPE_MICROBATCHES
    hvd.init(device="cuda")
    tokens, targets = tt.synthetic_lm_batch(
        torch.Generator().manual_seed(1), batch, seq, cfg.vocab_size)
    data = (tokens.cuda(), targets.cuda())
    chain = tt.chained_lm_loss(cfg)
    n_stages = len(chain.stages)
    per_step = {"flash_fwd": 2 * cfg.n_layers * m,  # forward + recompute
                "flash_bwd_dkdv": cfg.n_layers * m,
                "flash_bwd_dq": cfg.n_layers * m}

    def adamw(leaves):
        return torch.optim.AdamW(leaves, lr=lr, weight_decay=1e-4,
                                 foreach=True)

    def weights():
        return tt.init_transformer(torch.Generator().manual_seed(0), cfg,
                                   device="cuda")

    def build(kind, opt_fn=adamw):
        """The trainer's weights and AdamW: {"step": () -> loss,
        "leaves": () -> weights in chained_lm_params order, ...}."""
        params = weights()
        if kind == "monolithic":
            opt = hvd.DistributedOptimizer(adamw(tree_leaves(params)))
            step = hvd.make_train_step(tt.make_loss_fn(cfg), opt)
            return {"step": lambda: step(params, data), "optimizer": opt,
                    "leaves": lambda: tree_leaves(
                        tt.chained_lm_params(params, cfg))}
        schedule, interleave = {"gpipe": ("gpipe", 1), "1f1b": ("1f1b", 1),
                                "1f1b_v2": ("1f1b", 2)}[kind]
        stages = tt.chained_lm_params(params, cfg)
        del params
        pstep = PL.make_pipeline_train_step(
            chain, opt_fn, num_microbatches=m, schedule=schedule,
            interleave=interleave)
        held = {"p": stages, "opt": pstep.init(stages)}

        def one():
            held["p"], held["opt"], loss = pstep(held["p"], held["opt"],
                                                 data)
            return loss

        return {"step": one, "optimizer": held["opt"], "pipeline": pstep,
                "leaves": lambda: [x for st in held["p"]
                                   for x in tree_leaves(st)]}

    # 1. Three AdamW steps of each schedule from the same weights and
    # batch: losses and every weight bitwise across GPipe, 1F1B and
    # interleaved 1F1B; 192 / 96 / 96 launches a step.
    runs, path_launches = {}, None
    for kind in ("monolithic", "gpipe", "1f1b", "1f1b_v2"):
        fa.reset_launches()
        run = build(kind)
        losses = [float(run["step"]()) for _ in range(3)]
        launches = dict(fa.launches)
        if kind != "monolithic":
            if {k: v / 3 for k, v in launches.items()} != per_step:
                raise AssertionError(f"{kind}: flash launches over 3 steps "
                                     f"{launches}, not 3 x {per_step}")
            if kind == "1f1b":
                path_launches = launches
        runs[kind] = {"losses": losses,
                      "leaves": [p.detach().clone() for p in run["leaves"]()]}
        del run
        torch.cuda.empty_cache()
    mono = runs.pop("monolithic")
    base = runs["gpipe"]
    for kind in ("1f1b", "1f1b_v2"):
        r = runs[kind]
        if r["losses"] != base["losses"] or not all(
                torch.equal(a, b) for a, b in zip(r["leaves"],
                                                  base["leaves"])):
            raise AssertionError(f"{kind} is not bitwise gpipe: "
                                 f"{r['losses']} / {base['losses']}")
    if not all(np.isfinite(base["losses"])) or not (
            base["losses"][-1] < base["losses"][0]):
        raise AssertionError(f"pipeline losses: {base['losses']}")

    # 2. Against the monolithic step: the first loss within 1e-5
    # relative; the first step's gradients (reduced and divided, before
    # the optimizer) within PIPE_GRAD_ALLOWANCE x the bf16 allowance of
    # one whole-batch backward; the weights after 3 steps within AdamW's
    # bound.
    first_rel = abs(base["losses"][0] - mono["losses"][0]) / abs(
        mono["losses"][0])
    if not first_rel <= 1e-5:
        raise AssertionError(f"first loss {base['losses'][0]} against the "
                             f"monolithic {mono['losses'][0]}")
    cap = build("1f1b", opt_fn=_CaptureGrads)
    cap["step"]()
    got = [g for opt in cap["optimizer"] for g in opt.grads]
    del cap
    params = weights()
    stages = tt.chained_lm_params(params, cfg)
    del params
    chain(stages, data).backward()
    want = [p.grad for st in stages for p in tree_leaves(st)]
    grad_errs = [check(f"pipeline grad {i}", a, b, lambda w: (
        PIPE_GRAD_ALLOWANCE * bf16_allowed(w))) for i, (a, b) in
        enumerate(zip(got, want))]
    grad_row = {"allowance_multiple": PIPE_GRAD_ALLOWANCE,
                "worst_ratio_of_one_allowance": PIPE_GRAD_ALLOWANCE * max(
                    e[1] for e in grad_errs),
                "max_abs_err": max(e[0] for e in grad_errs),
                "bitwise": all(torch.equal(a, b) for a, b in zip(got, want))}
    del got, want, stages
    torch.cuda.empty_cache()
    param_worst = max(check("pipeline params", a, b, adamw_allowed(lr, 3))[1]
                      for a, b in zip(base["leaves"], mono["leaves"]))
    weights_bitwise = all(torch.equal(a, b) for a, b in
                          zip(base["leaves"], mono["leaves"]))
    log({"phase": "pipeline", "check": "GPT-2-small as chained_lm_loss, "
         f"{n_stages} stages, {m} microbatches, through "
         "make_pipeline_train_step under gpipe, 1f1b and 1f1b interleave 2, "
         "3 AdamW(3e-4, foreach) steps from the trainer's weights and "
         "batch; against make_train_step", "device": smi_line,
         "schedules_bitwise": True, "losses": base["losses"],
         "monolithic_losses": mono["losses"],
         "first_loss_rel_diff": first_rel, "first_step_grads": grad_row,
         "weights_bitwise_monolithic": weights_bitwise,
         "weights_worst_ratio_adamw_allowed": param_worst,
         "launches_per_step": {k: v / 3 for k, v in path_launches.items()}})
    del runs, mono, base
    torch.cuda.empty_cache()

    # 3-4. Timed in turns (monolithic, gpipe, 1f1b, 1f1b_v2, 1f1b, gpipe,
    # monolithic; 2 warm-up and 5 timed steps each): step ms, tokens/s,
    # the host's enqueue ms, pipeline.bubble_seconds, the memory held
    # between steps and the peak during them, the peak carries and their
    # bytes against the plan; one profiled 1F1B step.
    timed = {k: [] for k in ("monolithic", "gpipe", "1f1b", "1f1b_v2")}
    carry_bytes = batch // m * seq * cfg.d_model * 2  # one bf16 carry
    for turn in ("monolithic", "gpipe", "1f1b", "1f1b_v2", "1f1b", "gpipe",
                 "monolithic"):
        gc.collect()
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        fa.reset_launches()
        reg0 = telemetry.registry().snapshot(run_collectors=False)
        run = build(turn)
        for _ in range(warmup):
            run["step"]()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            run["step"]()
        enqueued = time.perf_counter() - t0
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        row = {"step_ms": seconds / steps * 1e3,
               "enqueue_ms": enqueued / steps * 1e3,
               "tokens_per_s": batch * seq * steps / seconds,
               "resident_gb": (resident - base_mem) / 2 ** 30,
               "peak_gb": (torch.cuda.max_memory_allocated() - base_mem)
               / 2 ** 30}
        if turn != "monolithic":
            if {k: v / (warmup + steps) for k, v in fa.launches.items()} \
                    != per_step:
                raise AssertionError(f"{turn}: flash launches "
                                     f"{dict(fa.launches)}")
            pstep = run["pipeline"]
            st = pstep.stats()
            plan = pstep.plan
            pipeline_series_equal_stats(reg0, st, turn)
            if st["pipeline.inflight_activations"] != plan.peak_activations \
                    or st["pipeline.inflight_activation_bytes"] != \
                    plan.peak_activations * carry_bytes:
                raise AssertionError(f"{turn}: peak carries {st} against "
                                     f"the plan's {plan.peak_activations}")
            row.update({
                "bubble_seconds_mean": st["pipeline.bubble_seconds"]["sum"]
                / st["pipeline.bubble_seconds"]["count"],
                "peak_carries": st["pipeline.inflight_activations"],
                "peak_carry_bytes": st["pipeline.inflight_activation_bytes"],
                "plan": {"ticks": plan.total_ticks,
                         "bubble_fraction": plan.bubble_fraction,
                         "peak_activations": plan.peak_activations},
                "buckets": pstep.bucket_count})
        timed[turn].append(row)
        if turn == "1f1b" and "1f1b_profile" not in timed:
            prof = profile_step(run["step"], out_dir, "pipeline_1f1b")
            timed["1f1b_profile"] = prof
        del run
    for turn in ("monolithic", "gpipe", "1f1b", "1f1b_v2"):
        timed[f"{turn}_mean_step_ms"] = float(np.mean(
            [r["step_ms"] for r in timed[turn]]))
    log({"phase": "pipeline_trainer", "model": "GPT-2-small",
         "stages": n_stages, "microbatches": m, "batch": batch, "seq": seq,
         "dtype": "bfloat16", "ranks": 1, "device": smi_line, **timed})
    # The counters above hold the launches exactly.  The profile shows
    # which forms ran; its counts may fall short by a few records (the
    # profiler drops some in a call with many profiling sessions: a full
    # run read 8,513 device events of a step that reads 8,527 alone), so
    # it is held to 99% of the launches and never above them.
    names = " ".join(timed["1f1b_profile"]["flash_kernels"])
    for want_name, n in (("flash_fwd_sm90_kernel", per_step["flash_fwd"]),
                         ("flash_bwd_dkdv_sm90_kernel",
                          per_step["flash_bwd_dkdv"]),
                         ("flash_bwd_dq_sm90_kernel",
                          per_step["flash_bwd_dq"])):
        ran = sum(c for name, c in
                  timed["1f1b_profile"]["flash_kernels"].items()
                  if want_name in name)
        if not 0.99 * n <= ran <= n:
            raise AssertionError(f"the profiled 1f1b step ran {want_name} "
                                 f"{ran} times, not {n}: {names}")
    for first_form in ("flash_fwd_kernel<", "flash_bwd_dkdv_kernel<",
                       "flash_bwd_dq_kernel<"):
        if first_form in names:
            raise AssertionError(f"the profiled step ran {first_form}")
    del timed
    torch.cuda.empty_cache()

    # 5. The three kernels at the microbatch's shape, b1 h12 s1024 d64, and
    # at the trainer's, b8: as the kernels phase times them, and with the
    # launches queued behind a spin (a b1 launch is shorter than the
    # host's enqueue of the next, so the first form times the host).
    kernel_rows = {}
    for b_ in (batch // m, batch):
        for queued in (False, True):
            kernel_rows[f"b{b_}{'_queued' if queued else ''}"] = kernel_case(
                fa, b=b_, h=cfg.n_heads, q_len=seq, kv_len=seq,
                d=cfg.d_model // cfg.n_heads, causal=True, q_offset=0,
                dtype=torch.bfloat16, seed=23, timing=True, queued=queued)
    log({"phase": "pipeline_kernels", "case": "h12 s1024 d64 causal bf16, "
         "b1 (one microbatch) and b8", "device": smi_line, **kernel_rows})

    # 6. gpipe through ParallelAxes(data, pipe) on a one-rank mesh (the pipe
    # axis has one stage), 2 microbatches, 3 AdamW steps of
    # make_parallel_train_step against the monolithic step.
    mesh = make_mesh(data=1, pipe=1)
    ax = tt.ParallelAxes(data="data", pipe="pipe", num_microbatches=2)

    def parallel_run(axes):
        params = weights()
        opt = adamw(tree_leaves(params))
        step = make_parallel_train_step(tt.make_loss_fn(cfg, axes, mesh),
                                        opt, mesh, ("data", None))
        losses = [float(step(params, data)) for _ in range(3)]
        return losses, [p.detach().clone() for p in tree_leaves(params)]

    fa.reset_launches()
    pipe_losses, pipe_leaves = parallel_run(ax)
    pipe_launches = {k: v / 3 for k, v in fa.launches.items()}
    mono_losses, mono_leaves = parallel_run(tt.ParallelAxes(data="data"))
    pipe_row = {"losses": pipe_losses, "monolithic_losses": mono_losses,
                "launches_per_step": pipe_launches,
                "bitwise": pipe_losses == mono_losses and all(
                    torch.equal(a, b) for a, b in zip(pipe_leaves,
                                                      mono_leaves))}
    if not pipe_row["bitwise"]:
        pipe_row["held"] = "adamw_allowed"
        pipe_row["param_worst_ratio"] = max(
            check("gpipe params", a, b, adamw_allowed(lr, 3))[1]
            for a, b in zip(pipe_leaves, mono_leaves))
        pipe_row["loss_max_rel_diff"] = max(
            abs(a - b) / abs(b) for a, b in zip(pipe_losses, mono_losses))
        if not pipe_row["loss_max_rel_diff"] <= RTOL_BF16:
            raise AssertionError(f"gpipe through ParallelAxes: {pipe_row}")
    if pipe_launches != {k: 2 * cfg.n_layers for k in fa.KERNELS}:
        raise AssertionError(f"gpipe over 2 microbatches: launches a step "
                             f"{pipe_launches}")
    del pipe_leaves, mono_leaves
    torch.cuda.empty_cache()

    # 7. A pipeline of 4 stages of 3 layers played in one process
    # (pipeline.play_gpipe), 4 microbatches of 2 sequences, against the
    # 12 layers in sequence: the output and the input's gradient within
    # the bf16 allowance, each weight gradient within PIPE_GRAD_ALLOWANCE
    # x it (its ticks' contributions summed in bf16).
    params = weights()
    layers = params["layers"]
    x0 = (params["embed"][data[0]] + params["pos_embed"][:seq]).detach()
    gen = torch.Generator(device="cuda").manual_seed(29)
    ct = torch.randn(x0.shape, generator=gen, device="cuda").to(x0.dtype)
    axes = tt._resolve_axes(tt.ParallelAxes(data=None), None)
    per = cfg.n_layers // 4

    def stage_fn(sp, x):
        for i in range(per):
            x, _ = tt._layer(x, tt._index_layer(sp, i), cfg, axes)
        return x

    def grads_of(run_fn):
        """``run_fn(layers, x)`` on fresh copies of the layers and of x,
        its backward from ``ct``: (output, x's gradient, the layers'
        gradients)."""
        leaves_, spec = tree_flatten(layers)
        mine = [t.detach().clone().requires_grad_(True) for t in leaves_]
        x = x0.clone().requires_grad_(True)
        y = run_fn(tree_unflatten(spec, mine), x)
        y.backward(ct)
        return y.detach(), x.grad, [t.grad for t in mine]

    def sequential(tree, x):
        for i in range(cfg.n_layers):
            x, _ = tt._layer(x, tt._index_layer(tree, i), cfg, axes)
        return x

    def played(tree, x):
        stages_ = [tree_map(lambda t, k=k: t[k * per:(k + 1) * per], tree)
                   for k in range(4)]
        return PL.play_gpipe(stage_fn, stages_, x, n=4, num_microbatches=4)

    fa.reset_launches()
    y_p, dx_p, dw_p = grads_of(played)
    play_launches = dict(fa.launches)
    y_s, dx_s, dw_s = grads_of(sequential)
    play_row = {
        "launches": play_launches,
        "out": check("played out", y_p, y_s, bf16_allowed),
        "dx": check("played dx", dx_p, dx_s, bf16_allowed),
        "dw_worst_ratio_of_one_allowance": PIPE_GRAD_ALLOWANCE * max(
            check(f"played dw {i}", a, b, lambda w: (
                PIPE_GRAD_ALLOWANCE * bf16_allowed(w)))[1]
            for i, (a, b) in enumerate(zip(dw_p, dw_s)))}
    del y_p, dx_p, dw_p, y_s, dx_s, dw_s, params, layers, x0, ct
    torch.cuda.empty_cache()
    log({"phase": "pipeline_gpipe", "device": smi_line,
         "parallel_axes_data_pipe": pipe_row,
         "played_4_stages_of_3_layers_4_microbatches": play_row})
    hvd.shutdown()
    return path_launches


CKPT_STEPS, CKPT_SAVE_AT = 6, 3  # run A's steps; run B saves after 3
CKPT_PIPE_STEPS, CKPT_PIPE_SAVE_AT = 2, 1
CKPT_TURNS = ("none", "write", "write", "none") * 3  # 6 of each


def checkpoint_tensor_bytes(tree) -> int:
    """Bytes of the tensors a checkpoint of ``tree`` holds: its tensor
    leaves and, for an object with ``state_dict()``, the tensors of its
    state dict (an optimizer's moments and step counts)."""
    from horovod_tpu_torch.utils.tree import tree_flatten

    total = 0
    for leaf in tree_flatten(tree, lambda x: hasattr(x, "state_dict"))[0]:
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "state_dict"):
            total += checkpoint_tensor_bytes(leaf.state_dict())
    return total


def phase_checkpoint(fa, smi_line, out_dir):
    """GPT-2-small saved mid-training and resumed bitwise through
    make_train_step, the ZeRO and FSDP steps and the 14-stage pipeline;
    the sharded round trip; the save's costs and the step with a write in
    flight; the ResNet example's resume.  Returns the flash launches of
    the resumed monolithic steps.  The checkpoints (about 0.82 GB each)
    live under ``out_dir/checkpoint_files`` for the phase only, removed
    also when it fails."""
    import shutil

    from horovod_tpu_torch.utils import checkpoint as ck

    files = os.path.join(out_dir, "checkpoint_files")
    shutil.rmtree(files, ignore_errors=True)
    os.makedirs(files)
    try:
        return _checkpoint_paths(fa, smi_line, out_dir, files)
    finally:
        ck.wait_for_writes()
        shutil.rmtree(files, ignore_errors=True)


def _checkpoint_paths(fa, smi_line, out_dir, files):
    import shutil

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import resnet50_synthetic as ex
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import pipeline as PL
    from horovod_tpu_torch.parallel.fsdp import make_fsdp_train_step
    from horovod_tpu_torch.parallel.zero import make_zero_train_step
    from horovod_tpu_torch.utils import checkpoint as ck
    from horovod_tpu_torch.utils import serialization
    from horovod_tpu_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = transformer_lm.bench_config()
    batch, seq, lr = 8, 1024, 3e-4
    hvd.init(device="cuda")
    tokens, targets = tt.synthetic_lm_batch(
        torch.Generator().manual_seed(1), batch, seq, cfg.vocab_size)
    data = (tokens.cuda(), targets.cuda())
    loss_fn = tt.make_loss_fn(cfg)

    def adamw(leaves):
        return torch.optim.AdamW(leaves, lr=lr, weight_decay=1e-4,
                                 foreach=True)

    def weights(seed):
        return tt.init_transformer(torch.Generator().manual_seed(seed), cfg,
                                   device="cuda")

    def build(kind, seed):
        """GPT-2-small from ``seed`` and AdamW through one step builder:
        {"step": () -> loss, "tree": () -> the tree to save and restore,
        "leaves": () -> the weights}."""
        params = weights(seed)
        if kind == "monolithic":
            opt = hvd.DistributedOptimizer(adamw(tree_leaves(params)))
            step = hvd.make_train_step(loss_fn, opt)
            return {"step": lambda: step(params, data),
                    "tree": lambda: {"params": params, "opt": opt},
                    "leaves": lambda: tree_leaves(params)}
        if kind == "zero":
            zstep = make_zero_train_step(loss_fn, adamw)
            held = {"opt": zstep.init(params)}

            def zero_step():
                _, held["opt"], loss = zstep.step(params, held["opt"], data)
                return loss

            return {"step": zero_step,
                    "tree": lambda: {"params": params, "opt": held["opt"]},
                    "leaves": lambda: tree_leaves(params)}
        if kind == "fsdp":
            # Saved as full_params(p_shard), restored into a whole tree
            # and re-sharded by shard_params before the next step.
            fstep = make_fsdp_train_step(loss_fn, adamw)
            p_shard, opt = fstep.init(params)
            held = {"p": p_shard, "opt": opt, "full": params}

            def fsdp_step():
                if held["full"] is not None:
                    held["p"] = fstep.shard_params(held["full"])
                    held["full"] = None
                held["p"], held["opt"], loss = fstep.step(
                    held["p"], held["opt"], data)
                return loss

            def fsdp_tree():
                if held["full"] is None:
                    held["full"] = fstep.full_params(held["p"])
                return {"params": held["full"], "opt": held["opt"]}

            return {"step": fsdp_step, "tree": fsdp_tree,
                    "leaves": lambda: tree_leaves(
                        fstep.full_params(held["p"]))}
        stages = tt.chained_lm_params(params, cfg)
        del params
        pstep = PL.make_pipeline_train_step(
            tt.chained_lm_loss(cfg), adamw,
            num_microbatches=PIPE_MICROBATCHES, schedule="1f1b")
        held = {"opt": pstep.init(stages)}

        def pipe_step():
            _, held["opt"], loss = pstep(stages, held["opt"], data)
            return loss

        return {"step": pipe_step,
                "tree": lambda: {"params": stages, "opt": held["opt"]},
                "leaves": lambda: [x for st in stages
                                   for x in tree_leaves(st)]}

    def resume(kind, steps, save_at, keep=False):
        """Run A: ``steps`` steps.  Run B: ``save_at`` steps, save_checkpoint
        without block, one more step before wait() (a snapshot that
        aliased the live tensors would write that step's update), then
        the weights from seed 1 and a fresh AdamW restored from the file,
        resume_epoch, and the remaining steps: losses and final weights
        bitwise run A's."""
        path = os.path.join(files, f"{kind}.msgpack")
        run = build(kind, 0)
        losses_a = [float(run["step"]()) for _ in range(steps)]
        weights_a = [p.detach().clone() for p in run["leaves"]()]
        del run
        gc.collect()
        torch.cuda.empty_cache()
        run = build(kind, 0)
        losses_b = [float(run["step"]()) for _ in range(save_at)]
        tree = run["tree"]()
        row = {"checkpoint_bytes": checkpoint_tensor_bytes(tree)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = ck.save_checkpoint(path, tree, step=save_at)
        row["save_call_s"] = time.perf_counter() - t0
        del tree
        after = float(run["step"]())  # while the write is in flight
        row["write_in_flight_after_step"] = not handle.done
        t0 = time.perf_counter()
        handle.wait()
        row["wait_s"] = time.perf_counter() - t0
        row["write_seconds"] = ck.stats()["checkpoint.write_seconds"]["last"]
        row["file_bytes"] = os.path.getsize(path)
        row["write_MB_per_s"] = row["file_bytes"] / row["write_seconds"] / 1e6
        del run
        gc.collect()
        torch.cuda.empty_cache()
        run = build(kind, 1)
        tree = run["tree"]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.restore_checkpoint(path, tree)
        torch.cuda.synchronize()
        row["restore_s"] = time.perf_counter() - t0
        del tree
        epoch = ck.resume_epoch(path)
        fa.reset_launches()
        losses_c = [float(run["step"]()) for _ in range(steps - save_at)]
        launches = dict(fa.launches)
        bitwise = (losses_b + losses_c == losses_a
                   and after == losses_a[save_at]
                   and all(torch.equal(a, b) for a, b in
                           zip(run["leaves"](), weights_a)))
        row.update(losses=losses_a, resumed_losses=losses_c,
                   step_during_write_loss=after, resume_epoch=epoch,
                   bitwise=bitwise, launches=launches)
        if epoch != save_at or not bitwise:
            raise AssertionError(f"{kind}: the resumed run is not bitwise "
                                 f"the straight one: {row}")
        if not all(np.isfinite(losses_a)) or not losses_a[-1] < losses_a[0]:
            raise AssertionError(f"{kind} losses: {losses_a}")
        if not keep:
            os.remove(path)
            del run
            gc.collect()
            torch.cuda.empty_cache()
            return row
        return row, run, path

    # 1. make_train_step: 6 straight steps against 3 + save + 3 resumed;
    # each flash kernel 12 times a resumed step, sm90 forms only (one more
    # resumed step profiled).
    mono, run, path = resume("monolithic", CKPT_STEPS, CKPT_SAVE_AT,
                             keep=True)
    path_launches = mono.pop("launches")
    if path_launches != {k: cfg.n_layers * (CKPT_STEPS - CKPT_SAVE_AT)
                         for k in fa.KERNELS}:
        raise AssertionError(f"the resumed steps' flash launches "
                             f"{path_launches}")
    # The counters above hold the count; the profile shows the forms. In
    # a run of every phase the profiler drops records (11 of the 12
    # forward kernels once here, 191 of 192 in the pipeline phase), so
    # each sm90 kernel must be recorded, never more often than launched,
    # and no first-form kernel at all.
    prof = profile_step(run["step"], out_dir, "checkpoint")
    names = " ".join(prof["flash_kernels"])
    for want in ("flash_fwd_sm90_kernel", "flash_bwd_dkdv_sm90_kernel",
                 "flash_bwd_dq_sm90_kernel"):
        ran = sum(n for name, n in prof["flash_kernels"].items()
                  if want in name)
        if not 1 <= ran <= cfg.n_layers:
            raise AssertionError(f"the profiled resumed step ran {want} "
                                 f"{ran} times: {names}")
    for first_form in ("flash_fwd_kernel<", "flash_bwd_dkdv_kernel<",
                       "flash_bwd_dq_kernel<"):
        if first_form in names:
            raise AssertionError(f"the profiled step ran {first_form}")
    mono["launches_per_resumed_step"] = {
        k: v / (CKPT_STEPS - CKPT_SAVE_AT) for k, v in path_launches.items()}
    mono["profiled_resumed_step"] = {
        k: prof[k] for k in ("profiled_step_ms", "device_busy_ms",
                             "device_idle_share", "flash_kernels")}

    # The restore's parts on the same file, into the resumed run's tree:
    # the read, the decode, the copy onto the card.
    tree = run["tree"]()
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        blob = f.read()
    t1 = time.perf_counter()
    state = serialization.msgpack_restore(blob)
    t2 = time.perf_counter()
    ck._restore_into(tree, state)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    mono["restore_parts_s"] = {"read": t1 - t0, "decode": t2 - t1,
                               "copy_to_card": t3 - t2}
    del blob, state, tree
    os.remove(path)
    os.remove(path + ".step")
    log({"phase": "checkpoint", "path": "make_train_step", "check":
         "GPT-2-small, AdamW(3e-4, foreach), 6 straight steps against 3, "
         "save_checkpoint({params, opt}) without block, a 4th step before "
         "wait(), restore into weights from seed 1 and a fresh AdamW, 3 "
         "resumed steps: bitwise", "device": smi_line, **mono})

    # 2. The sharded format: the run's tree at a virtual world of 4,
    # restored into weights from seed 2 and a fresh AdamW, bitwise.
    sharded_dir = os.path.join(files, "sharded")
    tree = run["tree"]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save_checkpoint_sharded(sharded_dir, tree, world=4, block=True)
    save_s = time.perf_counter() - t0
    other = build("monolithic", 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.restore_checkpoint_sharded(sharded_dir, other["tree"]())
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    mine, theirs = tree["opt"].state_dict(), other["tree"]()["opt"].state_dict()
    bitwise = all(torch.equal(a, b) for a, b in zip(
        run["leaves"](), other["leaves"]())) and all(
        torch.equal(mine["state"][i][k], theirs["state"][i][k])
        for i in mine["state"] for k in mine["state"][i]) and \
        mine["param_groups"] == theirs["param_groups"]
    man = ck.load_sharded_manifest(sharded_dir)
    sharded_row = {"world": man["world"], "save_s": save_s,
                   "restore_s": restore_s, "bitwise": bitwise,
                   "shard_bytes": sorted(
                       os.path.getsize(os.path.join(
                           sharded_dir, man["save_dir"], name))
                       for name in os.listdir(os.path.join(
                           sharded_dir, man["save_dir"]))
                       if name.endswith(".msgpack"))}
    if not bitwise:
        raise AssertionError(f"sharded round trip: {sharded_row}")
    del other, tree, mine, theirs
    shutil.rmtree(sharded_dir)
    gc.collect()
    torch.cuda.empty_cache()
    log({"phase": "checkpoint_sharded", "device": smi_line, **sharded_row})

    # 3. The step with a write in flight against none, in turns (none,
    # write, write, none, x3): a write turn starts save_checkpoint just
    # before the step and waits for it after.
    timed = {"none": [], "write": []}
    in_flight = 0
    turn_path = os.path.join(files, "turns.msgpack")
    for turn in CKPT_TURNS:
        handle = None
        if turn == "write":
            handle = ck.save_checkpoint(turn_path, run["tree"]())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(run["step"]())
        timed[turn].append((time.perf_counter() - t0) * 1e3)
        if handle is not None:
            in_flight += not handle.done
            handle.wait()
    os.remove(turn_path)
    log({"phase": "checkpoint_turns", "device": smi_line,
         "order": list(CKPT_TURNS), "step_ms": timed,
         "median_ms": {k: float(np.median(v)) for k, v in timed.items()},
         "write_turns_in_flight_at_step_end": in_flight,
         "stats": ck.stats()})
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # 4. ZeRO, FSDP (3 + 3 against 6) and the 14-stage 1f1b pipeline with
    # its per-stage optimizers (1 + 1 against 2).
    rows = {"zero": resume("zero", CKPT_STEPS, CKPT_SAVE_AT),
            "fsdp": resume("fsdp", CKPT_STEPS, CKPT_SAVE_AT),
            "pipeline_1f1b_14_stages": resume("pipeline", CKPT_PIPE_STEPS,
                                              CKPT_PIPE_SAVE_AT)}
    for row in rows.values():
        row["launches"] = {k: int(v) for k, v in row["launches"].items()}
    log({"phase": "checkpoint_sharded_steps", "device": smi_line, **rows})

    # 5. The ResNet example: fit(--full, epochs=1) saving its checkpoint,
    # then fit(epochs=2) resuming from it.
    seen = {}

    class Resumed:
        def set_trainer(self, trainer):
            self.trainer = trainer

        def on_train_begin(self, logs=None):
            seen["begin"] = [x.detach().clone() for x in tree_leaves(
                [self.trainer.params, self.trainer.model_state])]

        def on_epoch_begin(self, epoch, logs=None):
            seen.setdefault("epochs", []).append(epoch)

    path = os.path.join(files, "resnet50.msgpack")
    first = ex.fit(full=True, epochs=1, device="cuda", ckpt=path)
    first["checkpoint"].wait()
    saved = [x.detach().clone() for x in tree_leaves(
        [first["trainer"].params, first["trainer"].model_state])]
    del first
    gc.collect()
    torch.cuda.empty_cache()
    second = ex.fit(full=True, epochs=2, device="cuda", ckpt=path,
                    extra_callbacks=[Resumed()])
    second["checkpoint"].wait()
    trainer = second["trainer"]
    on_card = all(x.device.type == "cuda" for x in tree_leaves(
        [trainer.params, trainer.model_state]))
    resnet_row = {
        "start_epoch": second["start_epoch"], "epochs_run": seen["epochs"],
        "restored_bitwise": len(seen["begin"]) == len(saved) and all(
            torch.equal(a, b) for a, b in zip(seen["begin"], saved)),
        "history": second["history"], "on_cuda": on_card,
        "checkpoint_bytes": os.path.getsize(path)}
    if not (resnet_row["restored_bitwise"] and on_card
            and second["start_epoch"] == 1 and seen["epochs"] == [1]
            and np.isfinite(second["history"][0]["loss"])):
        raise AssertionError(f"the ResNet example's resume: {resnet_row}")
    log({"phase": "checkpoint_resnet", "device": smi_line, **resnet_row})
    del second, trainer, saved, seen
    gc.collect()
    torch.cuda.empty_cache()
    hvd.shutdown()
    return path_launches


SERVING_ROWS = (2, 16, 37, 65, 127, 512, 1024)
SERVING_BATCHES = (2, 16, 37)
# f32 kernel against plain: |kernel - plain| <= 1e-5 x the RMS of the
# plain output's row (the sums run in another order: the kernel's eight
# fixed K slices against the library's blocking).
SERVING_TOL_F32 = 1e-5


def _row_rms_allowed(tol):
    return lambda want: tol * want.pow(2).mean(dim=-1, keepdim=True).sqrt()


def _first_differing(full, part_fn, counts):
    """The counts M at which part_fn(M) differs from full[:M] in any
    bit."""
    return [m for m in counts if not torch.equal(part_fn(m), full[:m])]


def _torch_attention(q, k, v, q_pos):
    """The reference's formula as batched torch (the naive library form:
    one einsum each way over the whole batch), the yardstick of the
    row-invariance table."""
    hd = q.shape[-1]
    scores = torch.einsum("bshd,bchd->bhsc", q.float(), k.float()) * hd ** -0.5
    kv_pos = torch.arange(k.shape[1], device=q.device)
    mask = kv_pos[None, None, None, :] <= q_pos[:, None, :, None]
    scores = torch.where(mask, scores, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    return torch.einsum("bhsc,bchd->bshd", p, v.float()).to(q.dtype)


def serving_invariance(S, cfg, g):
    """Why the kernels exist: rows of each product and of the attention
    at M (or s, b) in SERVING_ROWS against the full run, for the library
    form and the port's kernel.  The kernels must be invariant."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    table = []
    x1024 = {K: torch.randn(1024, K, generator=g).cuda().bfloat16()
             for K in (d, f)}
    for name, K, N, out in (("qkv", d, 3 * d, None), ("wo", d, d, None),
                            ("w_in", d, f, None), ("w_out", f, d, None),
                            ("logits", d, V, torch.float32)):
        x = x1024[K]
        w = (torch.randn(K, N, generator=g) * K ** -0.5).cuda().bfloat16()
        if out is None:
            lib = lambda m: torch.matmul(x[:m], w)  # noqa: E731
        else:  # the training path's f32 logits
            lib = lambda m: torch.matmul(x[:m].float(), w.float())  # noqa
        ker = lambda m: S.serving_gemm(x[:m], w, out_dtype=out)  # noqa
        table.append({
            "op": f"{name} [M,{K}]@[{K},{N}]",
            "library": "torch.matmul",
            "library_differs_at": _first_differing(lib(1024), lib,
                                                   SERVING_ROWS),
            "kernel_differs_at": _first_differing(ker(1024), ker,
                                                  SERVING_ROWS)})
    H, hd, cap = cfg.n_heads, d // cfg.n_heads, 1024
    q = torch.randn(1, 1024, H, hd, generator=g).cuda().bfloat16()
    k = torch.randn(1, cap, H, hd, generator=g).cuda().bfloat16()
    v = torch.randn(1, cap, H, hd, generator=g).cuda().bfloat16()
    pos = torch.arange(1024, device="cuda")[None]

    def rows_of(fn):
        full = fn(q, k, v, pos)[0]
        return _first_differing(
            full, lambda s: fn(q[:, :s], k, v, pos[:, :s])[0], SERVING_ROWS)

    def batch_of(fn):
        # Row 0 of a batch of b sequences (decode shape, s = 2), the
        # others random, against the sequence alone.
        qb = torch.randn(max(SERVING_BATCHES), 2, H, hd, generator=g).cuda()
        kb = torch.randn(max(SERVING_BATCHES), cap, H, hd, generator=g).cuda()
        qb, kb = qb.bfloat16(), kb.bfloat16()
        pb = torch.randint(0, cap - 2, (max(SERVING_BATCHES), 1),
                           generator=g).cuda() + torch.arange(2).cuda()
        alone = fn(qb[:1], kb[:1], kb[:1], pb[:1])
        return [b for b in SERVING_BATCHES if not torch.equal(
            fn(qb[:b], kb[:b], kb[:b], pb[:b])[:1], alone)]

    for label, fn in (("torch formula (einsum)", _torch_attention),
                      ("kernel", S.cache_attention)):
        table.append({"op": f"cache_attention rows s, b1 h{H} cap{cap}",
                      "form": label, "differs_at": rows_of(fn)})
        table.append({"op": f"cache_attention batch b, s2 h{H} cap{cap}",
                      "form": label, "differs_at": batch_of(fn)})
    # The other ops of forward_step, recorded (no kernel of ours): a row
    # that changes bits here would break the contract checks below.
    ln_w = torch.ones(d, device="cuda", dtype=torch.bfloat16)
    xs = x1024[d]
    ys = torch.randn(1024, d, generator=g).cuda().bfloat16()
    for name, fn in (
            ("layer_norm", lambda m: torch.nn.functional.layer_norm(
                xs[:m], (d,), ln_w, ln_w)),
            ("gelu_tanh", lambda m: S.gelu_tanh(x1024[f][:m])),
            ("add", lambda m: xs[:m] + ys[:m])):
        table.append({"op": name, "library": "torch",
                      "library_differs_at": _first_differing(
                          fn(1024), fn, SERVING_ROWS)})
    for row in table:
        log({"phase": "serving_invariance", **row})
    bad = [r for r in table if r.get("kernel_differs_at")
           or (r.get("form") == "kernel" and r["differs_at"])]
    if bad:
        raise AssertionError(f"a serving kernel is not row-invariant: {bad}")
    return table


def _in_turns(fns, rounds=2, timer=None, **kw):
    """``timer`` (default cuda_time_ms) of each fn, interleaved a, b, b, a
    (``rounds`` times), averaged per fn: the forms timed in turns within
    one call."""
    timer = timer or cuda_time_ms
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    times = [[] for _ in fns]
    for _ in range(rounds):
        for i in order:
            times[i].append(timer(fns[i], **kw))
    return [sum(t) / len(t) for t in times]


def host_us_per_call(fn, calls=200) -> float:
    """Host microseconds to enqueue one fn() (no synchronisation inside
    the window): what a host-bound decode iteration pays a launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def serving_tensor_map_us(S, iters=1000) -> float:
    """Host microseconds to encode one of the Hopper serving forms' tensor
    maps (two a GEMM, three an attention launch)."""
    fn = S._build.library("serving").hvd_serving_tensor_map_us
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_double
    buf = torch.empty(8 * 1025 * 12 * 64, dtype=torch.bfloat16,
                      device="cuda")
    us = fn(buf.data_ptr(), iters)
    if not us > 0:
        raise AssertionError(f"tensor map encode failed ({us})")
    return us


def attention_case(S, g, *, label, b, s, H, hd, cap, lengths, host=False):
    """``cache_attention`` against its plain version on the card: ``b``
    sequences of ``s`` query rows starting at ``lengths`` (-1: an
    inactive slot) over K/V views of ``cap`` rows; two runs bitwise, the
    Hopper form by the counters, timed in turns with the first form,
    beside the bound, the plain version and SDPA; ``host``: the host µs
    of a launch too (the decode shape)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    form = S.cache_attention_form(torch.bfloat16, hd)
    if form != "sm90":
        raise AssertionError(f"cache_attention at hd {hd} takes the {form} "
                             f"form")
    q = torch.randn(b, s, H, hd, generator=g).cuda().bfloat16()
    k = torch.randn(b, cap, H, hd, generator=g).cuda().bfloat16()
    v = torch.randn(b, cap, H, hd, generator=g).cuda().bfloat16()
    pos = (lengths[:, None] + torch.arange(s)[None]).cuda()
    pos = torch.where(lengths[:, None].cuda() < 0, -1, pos)
    S.reset_launches()
    got = S.cache_attention(q, k, v, pos)
    again = S.cache_attention(q, k, v, pos)
    torch.cuda.synchronize()
    if S.launches_by_form[("cache_attention", "sm90")] != 2:
        raise AssertionError(f"cache_attention {label}: launches by "
                             f"form {S.launches_by_form}")
    if not torch.equal(got, again):
        raise AssertionError(f"cache_attention {label}: two runs differ")
    want = S.cache_attention_plain(q, k, v, pos)
    err, margin = check(f"cache_attention {label}", got, want, bf16_allowed)
    check(f"cache_attention {label} first form",
          S._first_form_attention(q, k, v, pos), want, bf16_allowed)
    if not bool((got[pos < 0] == 0).all()):
        raise AssertionError("an inactive row is not zero")
    # The bytes this run's rows need: q of the active rows, every output
    # row, and each batch's K and V rows up to its furthest query (the
    # kernels read j < min(q_pos + 1, cap) and nothing for an inactive
    # row); the products at the bf16 tensor-core rate.
    visible = int(torch.clamp(pos + 1, 0, cap).sum()) * H
    kv_rows = int(torch.clamp(pos + 1, 0, cap).amax(dim=1).sum())
    nbytes = (int((pos >= 0).sum()) * H * hd + b * s * H * hd
              + 2 * kv_rows * H * hd) * 2
    b_ms, b_by = bound(4.0 * visible * hd, nbytes, torch.bfloat16)
    mask = (torch.arange(cap, device="cuda")[None, None, None, :]
            <= pos[:, None, :, None])
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    ms, first_ms = _in_turns(
        [lambda: S.cache_attention(q, k, v, pos),
         lambda: S._first_form_attention(q, k, v, pos)],
        iters=20, queued=True)
    times = {}
    if host:
        (times["host_us"], times["first_form_host_us"],
         times["wrapper_host_us"]) = _in_turns(
            [lambda: S._sm90_attention(q, k, v, pos),
             lambda: S._first_form_attention(q, k, v, pos),
             lambda: S.cache_attention(q, k, v, pos)],
            rounds=2, timer=host_us_per_call)
    return {"form": form, "ms": ms, "first_form_ms": first_ms, **times,
            "plain_ms": cuda_time_ms(
                lambda: S.cache_attention_plain(q, k, v, pos), iters=2,
                warmup=1),
            "library_ms": cuda_time_ms(
                lambda: sdpa(qf, kf, vf, attn_mask=mask), iters=20,
                queued=True),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "worst_over_allowed": margin}


def serving_kernel_cases(S, cfg, g):
    """Each kernel against its plain version on the card at the main
    path's shapes, two runs bitwise, the form each case takes by the
    counters, timed beside the bound, the library call and (in turns)
    the first form's bf16 build; then K and V views holding NaN past
    every row's position."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    out = {}
    for M in (16, 1024):
        for name, K, N, dt, odt in (
                ("qkv", d, 3 * d, torch.bfloat16, torch.bfloat16),
                ("wo", d, d, torch.bfloat16, torch.bfloat16),
                ("w_in", d, f, torch.bfloat16, torch.bfloat16),
                ("w_out", f, d, torch.bfloat16, torch.bfloat16),
                ("logits", d, V, torch.bfloat16, torch.float32),
                ("w_in_f32", d, f, torch.float32, torch.float32)):
            x = torch.randn(M, K, generator=g).cuda().to(dt)
            w = (torch.randn(K, N, generator=g) * K ** -0.5).cuda().to(dt)
            form, tile_n, split = S.serving_gemm_form(dt, K, N)
            if form != ("sm90" if dt == torch.bfloat16 else "first"):
                raise AssertionError(f"serving_gemm {name} takes the {form} "
                                     f"form")
            S.reset_launches()
            got = S.serving_gemm(x, w, out_dtype=odt)
            again = S.serving_gemm(x, w, out_dtype=odt)
            torch.cuda.synchronize()
            if S.launches_by_form[("serving_gemm", form)] != 2 or \
                    S.launches["serving_gemm"] != 2:
                raise AssertionError(f"serving_gemm {name}: launches by "
                                     f"form {S.launches_by_form}")
            if not torch.equal(got, again):
                raise AssertionError(f"serving_gemm {name} M{M}: two runs "
                                     f"differ")
            want = S.serving_gemm_plain(x, w, odt)
            allowed = (bf16_allowed if odt == torch.bfloat16
                       else _row_rms_allowed(SERVING_TOL_F32))
            err, margin = check(f"serving_gemm {name} M{M}", got, want,
                                allowed)
            first = S._first_form_gemm(x, w, odt)
            check(f"serving_gemm {name} M{M} first form", first, want,
                  allowed)
            nbytes = (M * K + K * N) * x.element_size() + M * N * (
                2 if odt == torch.bfloat16 else 4)
            b_ms, b_by = bound(2.0 * M * N * K, nbytes, dt)
            # f32 out: torch.matmul of f32 copies, made off the clock.
            xf, wf = (x, w) if odt == dt else (x.float(), w.float())
            lib = lambda: torch.matmul(xf, wf)  # noqa: E731
            ms, first_ms = _in_turns(
                [lambda: S.serving_gemm(x, w, odt),
                 lambda: S._first_form_gemm(x, w, odt)],
                iters=20, queued=True)
            host = {}
            if M == 16:  # the decode shape: the host's cost of a launch
                # Each form's launcher in turns (the same work around
                # it), and the path's wrapper, which adds the checks.
                (host["host_us"], host["first_form_host_us"],
                 host["wrapper_host_us"]) = _in_turns(
                    [lambda: S._sm90_gemm(x, w, odt, tile_n, split)
                     if form == "sm90" else S._first_form_gemm(x, w, odt),
                     lambda: S._first_form_gemm(x, w, odt),
                     lambda: S.serving_gemm(x, w, odt)],
                    rounds=2, timer=host_us_per_call)
            out[f"gemm_{name}_M{M}"] = {
                "form": form, "tile_n": tile_n, "split": split, "ms": ms,
                "first_form_ms": first_ms, **host,
                "plain_ms": cuda_time_ms(
                    lambda: S.serving_gemm_plain(x, w, odt), iters=3,
                    warmup=1),
                "library_ms": cuda_time_ms(lib, iters=20, queued=True),
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                "worst_over_allowed": margin}
    # Strided operands read in place: x a column slice of a wider matrix
    # (as q of a fused QKV product), w a column slice of a wider weight,
    # at decode and prefill, split and unsplit; the same bits as on
    # contiguous copies, within the allowance of the plain version.
    for M, K, N in ((16, f, d), (1024, f, d), (16, d, f), (1024, d, 3 * d)):
        xb = torch.randn(M, 3 * K, generator=g).cuda().bfloat16()
        wb = (torch.randn(K, N + 64, generator=g) * K ** -0.5).cuda().to(
            torch.bfloat16)
        xs, ws = xb[:, K:2 * K], wb[:, 64:]
        got = S.serving_gemm(xs, ws)
        if not torch.equal(got, S.serving_gemm(xs.contiguous(),
                                               ws.contiguous())):
            raise AssertionError(f"serving_gemm on strided operands M{M} "
                                 f"K{K} N{N} differs from contiguous copies")
        err, margin = check(f"serving_gemm strided M{M} K{K} N{N}", got,
                            S.serving_gemm_plain(xs, ws), bf16_allowed)
        out[f"gemm_strided_M{M}_K{K}_N{N}"] = {
            "split": S.serving_gemm_form(torch.bfloat16, K, N)[2],
            "max_abs_err": err, "worst_over_allowed": margin}
    H, hd, cap = cfg.n_heads, d // cfg.n_heads, 1024
    for label, b, s, lengths in (
            ("decode", 8, 2, torch.tensor([0, 5, 100, 511, 700, 1000, 1021,
                                           -1])),
            ("prefill", 1, 1024, torch.tensor([0]))):
        out[f"attention_{label}"] = attention_case(
            S, g, label=label, b=b, s=s, H=H, hd=hd, cap=cap,
            lengths=lengths, host=label == "decode")
    # NaN past every row's position, in views one row longer than the
    # capacity (forward_step's): the output finite and within tolerance
    # of the plain version on a zeroed copy, at decode and prefill.
    for label, b, s, lengths in (
            ("nan_tail_decode", 8, 2, torch.tensor([0, 5, 63, 64, 100, 700,
                                                    1021, -1])),
            ("nan_tail_prefill", 2, 127, torch.tensor([0, 300]))):
        q = torch.randn(b, s, H, hd, generator=g).cuda().bfloat16()
        kbuf = torch.randn(b, cap + 1, H, hd, generator=g).cuda().bfloat16()
        vbuf = torch.randn(b, cap + 1, H, hd, generator=g).cuda().bfloat16()
        k, v = kbuf[:, :cap], vbuf[:, :cap]
        pos = (lengths[:, None] + torch.arange(s)[None]).cuda()
        pos = torch.where(lengths[:, None].cuda() < 0, -1, pos)
        kz, vz = k.clone(), v.clone()
        for bi in range(b):
            last = max(0, int(pos[bi].max()) + 1)
            k[bi, last:], v[bi, last:] = float("nan"), float("nan")
            kz[bi, last:], vz[bi, last:] = 0.0, 0.0
        got = S.cache_attention(q, k, v, pos)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"cache_attention {label}: NaN past the "
                                 f"rows' positions reached the output")
        err, margin = check(f"cache_attention {label}", got,
                            S.cache_attention_plain(q, kz, vz, pos),
                            bf16_allowed)
        out[f"attention_{label}"] = {"max_abs_err": err,
                                     "worst_over_allowed": margin}
    out["tensor_map_encode_us"] = serving_tensor_map_us(S)
    for key, r in out.items():
        log({"phase": "serving_kernel", "case": key,
             **(r if isinstance(r, dict) else {"value": r})})
    # Each Hopper form faster than its first form at the prefill shapes.
    slower = {k: (r["ms"], r["first_form_ms"]) for k, r in out.items()
              if isinstance(r, dict) and r.get("form") == "sm90"
              and ("M1024" in k or k == "attention_prefill")
              and not r["ms"] < r["first_form_ms"]}
    if slower:
        raise AssertionError(f"a Hopper form is not faster than its first "
                             f"form at prefill: {slower}")
    return out


class _Capture:
    """Records each request's logits rows on an engine: the prefill's
    last row, then its row of every decode iteration."""

    def __init__(self, engine):
        self.rows = {}
        self.times = {"decode": [], "prefill": {}}
        pf, dec = engine._prefill, engine._decode_iteration

        def prefill(slot, req):
            t0 = time.perf_counter()
            last = pf(slot, req)
            self.times["prefill"].setdefault(
                engine._bucket_for(len(req.prompt)), []).append(
                (time.perf_counter() - t0) * 1e3)
            self.rows.setdefault(req.rid, []).append(last.copy())
            return last

        def decode(active):
            t0 = time.perf_counter()
            logits = dec(active)
            self.times["decode"].append((time.perf_counter() - t0) * 1e3)
            for slot, req in active:
                self.rows.setdefault(req.rid, []).append(logits[slot].copy())
            return logits

        engine._prefill, engine._decode_iteration = prefill, decode


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * (len(xs) - 1)))] if xs else None


def prefill_decode_bitwise(engine_of, forward, prompts, news, capacity):
    """The contract's first clause on one engine: each prompt's prefill
    and its width-2 decodes, sharing the decode batch, give the logits
    rows of ``forward`` (serving_forward) over the prompt and its tokens,
    bit for bit; the last prompt decodes to the capacity boundary.
    Returns the rows checked."""
    eng = engine_of()
    cap = _Capture(eng)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    eng.run_until_idle()
    checked = 0
    for p, r in zip(prompts, reqs):
        gen = r.result(0)
        ref = forward(p + gen[:-1])
        rows = cap.rows[r.rid]
        if len(rows) != len(gen):
            raise AssertionError(f"{len(rows)} logits rows for {len(gen)} "
                                 f"tokens")
        for i, row in enumerate(rows):
            if row.tobytes() != ref[len(p) - 1 + i].tobytes():
                raise AssertionError(
                    f"prompt {len(p)}: row {i} (position {len(p) - 1 + i}) "
                    f"differs from serving_forward")
            checked += 1
    if reqs[-1].finish_reason != "capacity" or \
            len(prompts[-1]) + len(reqs[-1].result(0)) != capacity:
        raise AssertionError(f"the {len(prompts[-1])}-token prompt did not "
                             f"decode to the capacity boundary")
    return checked


def serving_contract(cfg, params, engine_of, g):
    """The bitwise contract on the card, at GPT-2-small's widths."""
    import horovod_tpu_torch.telemetry as telemetry
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.serving import harness

    V = cfg.vocab_size

    def prompt(n, seed):
        return torch.randint(0, V, (n,),
                             generator=torch.Generator().manual_seed(
                                 seed)).tolist()

    def forward(tokens):
        with torch.no_grad():
            return tt.serving_forward(params, torch.tensor(
                [tokens], device="cuda"), cfg, 1024)[0].cpu().numpy()

    result = {}
    # (a) prefill p + N width-2 decodes == serving_forward, row by row,
    # three prompts sharing the decode batch; the 1000-token one decodes
    # to the capacity boundary.
    checked = prefill_decode_bitwise(
        engine_of, forward, [prompt(7, 1), prompt(300, 2), prompt(1000, 3)],
        (16, 16, 64), 1024)
    result["prefill_decode_rows_bitwise"] = checked
    # (b) a ragged batch of 8 slots == each sequence alone.
    ragged = [prompt(n, 10 + i) for i, n in
              enumerate((5, 17, 64, 100, 255, 256, 400, 731))]
    eng = engine_of()
    cap_b = _Capture(eng)
    batch = [eng.submit(p, max_new_tokens=8) for p in ragged]
    eng.run_until_idle()
    eng = engine_of()
    cap_s = _Capture(eng)
    for p, r in zip(ragged, batch):
        alone = eng.submit(p, max_new_tokens=8)
        eng.run_until_idle()
        if alone.result(0) != r.result(0) or [
                x.tobytes() for x in cap_s.rows[alone.rid]] != [
                x.tobytes() for x in cap_b.rows[r.rid]]:
            raise AssertionError(f"prompt {len(p)}: the batched rows differ "
                                 f"from the sequence alone")
    result["ragged_batch_bitwise"] = len(ragged)
    # (c) the engine's greedy rollout == the token-by-token argmax of
    # serving_forward.
    p = prompt(12, 30)
    got = eng.generate(p, max_new_tokens=16)
    seq, want = list(p), []
    for _ in range(16):
        want.append(int(np.argmax(forward(seq)[-1])))
        seq.append(want[-1])
    if got != want:
        raise AssertionError(f"greedy rollout {got} != argmax {want}")
    result["greedy_rollout_tokens"] = len(got)
    # (d) a prefix-cache hit == a cold prefill, with fewer prefill tokens.
    header = prompt(512, 40)
    cold = engine_of(prefix_cache=False)
    cap_c = _Capture(cold)
    hot = engine_of(prefix_cache=True)
    cap_h = _Capture(hot)
    hot.generate(header + [1, 2], max_new_tokens=4)
    ext = header + prompt(20, 41)

    def prefill_tokens():
        return telemetry.metrics()["serving.prefill_tokens"]["value"]

    t0 = prefill_tokens()
    r_hot = hot.submit(ext, max_new_tokens=8)
    hot.run_until_idle()
    hot_tokens = prefill_tokens() - t0
    t0 = prefill_tokens()
    r_cold = cold.submit(ext, max_new_tokens=8)
    cold.run_until_idle()
    cold_tokens = prefill_tokens() - t0
    if r_hot.result(0) != r_cold.result(0) or [
            x.tobytes() for x in cap_h.rows[r_hot.rid]] != [
            x.tobytes() for x in cap_c.rows[r_cold.rid]]:
        raise AssertionError("the prefix-cache hit differs from the cold "
                             "prefill")
    if not hot_tokens < cold_tokens:
        raise AssertionError(f"the hit ran {hot_tokens} prefill tokens, the "
                             f"cold prefill {cold_tokens}")
    result["prefix_hit"] = {"prefill_tokens_hit": hot_tokens,
                            "prefill_tokens_cold": cold_tokens,
                            "pages_shared": len(header) // 16}
    del cold, hot, eng
    # (e) speculative decoding (spec_tokens 3) == plain decode: the
    # agreement pair (2-layer draft, acceptance 1.0) and an uncorrelated
    # 2-layer full-width draft.
    dcfg = dataclasses.replace(cfg, n_layers=2)
    tp, dp = harness.agreement_pair(cfg, dcfg, device="cuda")
    rand_draft = tt.init_transformer(torch.Generator().manual_seed(1), dcfg,
                                     device="cuda")
    spec_prompts = [prompt(9, 50), prompt(33, 51), prompt(200, 52)]
    result["speculative"] = {}
    for label, target, draft in (("agreement", tp, dp),
                                 ("uncorrelated", params, rand_draft)):
        plain = engine_of(params=target)
        want = [plain.generate(p, max_new_tokens=16) for p in spec_prompts]
        del plain
        spec = engine_of(params=target, draft=(draft, dcfg), spec_tokens=3)
        spec.warm_start()
        reqs = [spec.submit(p, max_new_tokens=16) for p in spec_prompts]
        iters = spec.run_until_idle()
        got = [r.result(0) for r in reqs]
        if got != want:
            raise AssertionError(f"speculative ({label}) tokens differ from "
                                 f"plain decode")
        rate = spec.spec_acceptance_rate
        if label == "agreement" and rate != 1.0:
            raise AssertionError(f"agreement pair accepted {rate}")
        result["speculative"][label] = {"acceptance": rate,
                                        "iterations": iters}
        del spec
    log({"phase": "serving_contract", **result})
    return result


def serving_traffic(cfg, engine_of, S, out_dir):
    """bench.py's trace (seed 7, 40 requests) at GPT-2-small's vocab:
    continuous against static batching, identical tokens; then 8 long
    prompts (512-1000 tokens) so the 1024 bucket runs at full width."""
    from horovod_tpu_torch.serving import harness

    trace = harness.serving_trace(40, cfg.vocab_size, seed=7)
    warm = engine_of()
    warm.warm_start()
    for n in (4, 16):  # the trace's prefill buckets, off the clock
        warm.generate(list(range(1, n + 1)), max_new_tokens=2)
    del warm
    legs, launches = {}, None
    for continuous in (True, False):
        eng = engine_of()
        eng.warm_start()
        cap = _Capture(eng)
        if continuous:
            S.reset_launches()
        run = harness.run_trace(eng, trace, continuous)
        if continuous:
            launches = dict(S.launches)
            launches["by_form"] = {f"{name}/{form}": n for (name, form), n
                                   in S.launches_by_form.items()}
        reqs = run["requests"]
        tokens = sum(len(t) for t in run["tokens"])
        ttft = [(r.t_first_token - r.t_submit) * 1e3 for r in reqs]
        per_tok = [(r.t_done - r.t_first_token) / (len(r.generated) - 1)
                   * 1e3 for r in reqs if len(r.generated) > 1]
        legs["continuous" if continuous else "static"] = {
            "tokens_per_s": tokens / run["seconds"], "tokens": tokens,
            "iterations": run["iterations"], "seconds": run["seconds"],
            "ttft_ms_p50": _pct(ttft, 0.5), "ttft_ms_p99": _pct(ttft, 0.99),
            "token_ms_p50": _pct(per_tok, 0.5),
            "token_ms_p99": _pct(per_tok, 0.99),
            "decode_iteration_ms_p50": _pct(cap.times["decode"], 0.5),
            "decode_iterations": len(cap.times["decode"]),
            "prefill_ms_by_bucket_p50": {
                b: _pct(ts, 0.5) for b, ts in sorted(
                    cap.times["prefill"].items())},
            "out": run["tokens"]}
        if continuous:
            # One profiled decode iteration of a full batch.
            for i in range(8):
                eng.submit(list(range(1, 20 + i)), max_new_tokens=40)
            eng.step()
            eng.step()
            prof = profile_step(eng.step, out_dir, "serving_decode")
            eng.run_until_idle()
            legs["continuous"]["profiled_decode"] = {
                k: prof[k] for k in ("device_busy_ms", "device_events",
                                     "profiled_step_ms", "device_idle_share",
                                     "enqueue_ms", "top")}
        del eng
    if legs["continuous"]["out"] != legs["static"]["out"]:
        raise AssertionError("continuous and static batching gave different "
                             "tokens")
    for leg in legs.values():
        leg.pop("out")
    # Long prompts: the 1024 bucket at full width, 8 slots deep.
    eng = engine_of()
    eng.warm_start()
    cap = _Capture(eng)
    g = torch.Generator().manual_seed(60)
    lens = torch.randint(512, 1001, (8,), generator=g).tolist()
    reqs = [eng.submit(torch.randint(0, cfg.vocab_size, (n,),
                                     generator=g).tolist(),
                       max_new_tokens=16) for n in lens]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters = eng.run_until_idle()
    long = {"prompt_lengths": lens, "iterations": iters,
            "seconds": time.perf_counter() - t0,
            "tokens": sum(len(r.result(0)) for r in reqs),
            "decode_iteration_ms_p50": _pct(cap.times["decode"], 0.5),
            "prefill_ms_by_bucket_p50": {
                b: _pct(ts, 0.5) for b, ts in sorted(
                    cap.times["prefill"].items())}}
    if 1024 not in long["prefill_ms_by_bucket_p50"]:
        raise AssertionError("no prompt ran the 1024 bucket")
    log({"phase": "serving_traffic", **legs, "long_prompts": long,
         "launches_continuous": launches})
    return legs, long, launches


def serving_http(cfg, params, engine_of):
    """LMServer on 127.0.0.1, port 0: /healthz NOT_READY then READY, 4
    concurrent /generate answers equal to engine.generate's, and a client
    that disconnects frees its slot."""
    import socket
    import urllib.error
    import urllib.request

    import horovod_tpu_torch.telemetry as telemetry
    from horovod_tpu_torch.serving import LMServer
    from horovod_tpu_torch.telemetry import exporter

    def post(url, payload):
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    prompts = [[i + 1, 2, 3, 4 + i] for i in range(4)]
    engine = engine_of()
    want = [engine.generate(p, max_new_tokens=12) for p in prompts]
    routes = exporter.RouteRegistry()
    routes.register_health("serving", engine.health)
    exp = exporter.start_exporter(telemetry.registry(), 0, host="127.0.0.1",
                                  routes=routes)
    base = f"http://127.0.0.1:{exp.port}"
    try:
        try:
            urllib.request.urlopen(base + "/healthz", timeout=30)
            raise AssertionError("/healthz was ready before warm_start")
        except urllib.error.HTTPError as e:
            if e.code != 503:
                raise
        with LMServer(engine, routes=routes, port=0) as srv:
            srv.start()
            with urllib.request.urlopen(base + "/healthz",
                                        timeout=30) as r:
                health = json.loads(r.read())
            if health["status"] != "ok" or health["serving"]["device"] \
                    != "cuda:0":
                raise AssertionError(f"/healthz after start: {health}")
            results = {}
            t0 = time.perf_counter()
            threads = [threading.Thread(target=lambda i=i: results.__setitem__(
                i, post(base + "/generate", {"tokens": prompts[i],
                                             "max_tokens": 12})))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            http_s = time.perf_counter() - t0
            got = [results[i]["tokens"] for i in range(4)]
            if got != want:
                raise AssertionError(f"HTTP answers {got} != {want}")
            # A client that disconnects mid-generation frees its slot.
            before = telemetry.metrics().get(
                "serving.client_disconnects", {}).get("value", 0)
            body = json.dumps({"tokens": [5, 6, 7], "max_tokens": 1000,
                               "timeout": 120}).encode()
            sock = socket.create_connection(("127.0.0.1", srv.port),
                                            timeout=30)
            sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Content-Length: " + str(len(body)).encode()
                         + b"\r\n\r\n" + body)
            deadline = time.monotonic() + 60
            while engine.scheduler.occupancy() == 0:
                if time.monotonic() > deadline:
                    raise AssertionError("the request was never admitted")
                time.sleep(0.005)
            sock.close()
            while engine.scheduler.occupancy():
                if time.monotonic() > deadline:
                    raise AssertionError("the disconnected slot was not "
                                         "freed")
                time.sleep(0.005)
            after = telemetry.metrics().get(
                "serving.client_disconnects", {}).get("value", 0)
            if after != before + 1:
                raise AssertionError("the disconnect was not counted")
    finally:
        exp.close()
    out = {"concurrent_requests": 4, "seconds": http_s,
           "ttft_ms": [results[i]["ttft_ms"] for i in range(4)],
           "disconnect_freed_slot": True}
    log({"phase": "serving_http", **out})
    return out


def phase_serving(fa, smi_line, out_dir):
    """GPT-2-small served on the card by the port's engine (ROADMAP A.4):
    the kernels' row invariance, each kernel's forms against its plain
    version (with NaN past the rows' positions), the bitwise contract, continuous against static batching, LMServer
    over HTTP, a serving checkpoint.  The flash kernels must not launch.
    Returns the serving kernels' launches on the continuous leg (the main
    path), the flash launches of the phase and the kernel numbers."""
    import shutil

    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import serving as S
    from horovod_tpu_torch.serving import InferenceEngine
    from horovod_tpu_torch.utils import checkpoint as ck
    from horovod_tpu_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    fa.reset_launches()
    cfg = transformer_lm.bench_config()
    params = tree_map(lambda x: x.detach(), tt.init_transformer(
        torch.Generator().manual_seed(0), cfg, device="cuda"))
    g = torch.Generator().manual_seed(0)

    def engine_of(params=params, **kw):
        return InferenceEngine(params, cfg, device="cuda", max_slots=8,
                               page_size=16, capacity=1024, **kw)

    eng = engine_of()
    pool_bytes = eng.cache.k_pages.nbytes + eng.cache.v_pages.nbytes
    if eng.cache.n_pages != 513 or pool_bytes != 302_579_712:
        raise AssertionError(f"KV pool {eng.cache.n_pages} pages, "
                             f"{pool_bytes} B")
    del eng
    table = serving_invariance(S, cfg, g)
    cases = serving_kernel_cases(S, cfg, g)
    contract = serving_contract(cfg, params, engine_of, g)
    legs, long, launches = serving_traffic(cfg, engine_of, S, out_dir)
    http = serving_http(cfg, params, engine_of)
    # A serving checkpoint saved from the card, loaded, served alike.
    files = os.path.join(out_dir, "serving_ckpt")
    shutil.rmtree(files, ignore_errors=True)
    try:
        ck.save_serving_checkpoint(files, params, cfg, block=True)
        p2, cfg2, _ = ck.load_serving_checkpoint(files)
        prompt = [11, 22, 33, 44, 55]
        a = engine_of().generate(prompt, max_new_tokens=12)
        b = engine_of(params=p2).generate(prompt, max_new_tokens=12)
        if cfg2 != cfg or a != b:
            raise AssertionError("the reloaded serving checkpoint serves "
                                 "other tokens")
    finally:
        shutil.rmtree(files, ignore_errors=True)
    if any(fa.launches.values()):
        raise AssertionError(f"the serving phase launched flash kernels: "
                             f"{fa.launches}")
    for name in S.KERNELS:
        if not launches.get(name):
            raise AssertionError(f"{name} never launched on the serving "
                                 f"path: {launches}")
        # The bf16 path runs the Hopper forms only.
        if launches["by_form"][f"{name}/first"] or \
                launches["by_form"][f"{name}/sm90"] != launches[name]:
            raise AssertionError(f"{name}: the bf16 serving path launched "
                                 f"other forms than sm90: {launches}")
    log({"phase": "serving", "device": smi_line, "kv_pool_pages": 513,
         "kv_pool_bytes": pool_bytes, "flash_launches": dict(fa.launches),
         "serving_launches": launches, "checkpoint_tokens_equal": True,
         "seconds": time.perf_counter() - t_phase})
    return {"launches": launches, "flash_launches": dict(fa.launches),
            "cases": cases, "table": table, "contract": contract,
            "traffic": legs, "long": long, "http": http}


# serving_mp phase: the rest of serving (ROADMAP A.4): followers, the
# serving kernels at the model axis's shard shapes, the axis itself.

# The model axes whose shard shapes the kernels are held at (GPT-2-small:
# 12 heads, d_ff 3072).
SHARD_AXES = (2, 4)


def _relayed_pair(engine_of, **kw):
    """Rank 0 and a follower as two engines in one process: the leader's
    broadcasts are pickled into a queue the follower's receptions read
    (one card, and NCCL puts no two ranks on one device)."""
    import collections
    import pickle

    box = collections.deque()
    leader, follower = engine_of(**kw), engine_of(**kw)
    leader._multiprocess = lambda: True
    leader._bcast = lambda obj: box.append(pickle.dumps(obj))
    follower._bcast = lambda obj: pickle.loads(box.popleft())
    return leader, follower, box


def _mirrored(a, b):
    """None when the follower's pools, page tables, lengths, free lists,
    prefix LRUs and indexes and live slots' tokens are the leader's,
    else what differs.  The trash
    page 0 is left out: padded and inactive positions write it with
    duplicate indices, and which duplicate lands is the device's choice
    (``kv_cache.write``); nothing reads it unmasked.  A freed slot's last
    token is not state either (the leader keeps its pending token, the
    follower the fed one)."""
    for name, ca, cb in (("target", a.cache, b.cache),
                         ("draft", a.draft_cache, b.draft_cache)):
        if ca is None:
            continue
        for part in ("k_pages", "v_pages"):
            pa, pb = getattr(ca, part)[:, 1:], getattr(cb, part)[:, 1:]
            if not torch.equal(pa, pb):
                pages = (pa != pb).flatten(2).any(-1).any(0).nonzero()
                return f"{name} {part}: pages {(pages + 1).flatten().tolist()}"
        if not np.array_equal(ca._table, cb._table):
            return f"{name} page table"
        if not np.array_equal(ca._lengths, cb._lengths):
            return f"{name} lengths {ca._lengths} {cb._lengths}"
        # The free list and the prefix LRU in their order, the prefix
        # index in its insertion order and the reference counts: what the
        # next allocation and eviction read.
        for part in ("_free", "_lru", "_index", "_refcount"):
            pa, pb = getattr(ca, part), getattr(cb, part)
            if list(pa.items() if isinstance(pa, dict) else pa) != \
                    list(pb.items() if isinstance(pb, dict) else pb):
                return f"{name} {part}"
    live = a.cache._lengths >= 0
    for part in ("_last_token", "_prev_token"):
        if not np.array_equal(getattr(a, part)[live],
                              getattr(b, part)[live]):
            return f"{part} {getattr(a, part)} {getattr(b, part)}"
    return None


def serving_pressure(leader, cfg, g):
    """A client abort and an admission that finishes at its prefill in
    one iteration, on a nearly full pool (``leader.step`` checks the
    follower after each iteration): A (1000 tokens, 63 pages of 16)
    runs, then B (one new token) and six more 1000-token prompts take
    441 of the 449 free pages while A's client aborts; then E maps 32 of
    A's cached pages and F's 63 pages come mostly out of the prefix LRU.
    Returns the iterations and the pool's low point."""
    n = 1000

    def prompt():
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    low = [leader.cache.free_pages()]

    def step():
        leader.step()
        low.append(leader.cache.free_pages())
        return not leader.scheduler.idle()

    pa = prompt()
    a = leader.submit(pa, max_new_tokens=6)
    step()
    b = leader.submit(prompt(), max_new_tokens=1)
    rest = [leader.submit(prompt(), max_new_tokens=4) for _ in range(6)]
    if leader.abort_request(a) != "active":
        raise AssertionError("A was not active at its abort")
    step()
    if b.finish_reason != "max_new_tokens" or len(b.result(0)) != 1 or \
            any(not r.generated for r in rest):
        raise AssertionError("B did not finish at its prefill beside six "
                             "admissions")
    e = leader.submit(pa[:512] + [5, 6, 7], max_new_tokens=3)
    f = leader.submit(prompt(), max_new_tokens=3)
    iters = 2
    while step():
        iters += 1
    if a.finish_reason != "client_disconnect" or \
            any(len(r.result(0)) != k for r, k in
                ([(e, 3), (f, 3)] + [(r, 4) for r in rest])):
        raise AssertionError("the pressure trace's requests did not finish")
    return {"iterations": iters + 1, "min_free_pages": min(low),
            "pages": leader.cache.n_pages - 1}


def serving_followers(cfg, params, engine_of, S):
    """bench.py's trace on a leader with a follower calling follow()
    after every step(), plain and speculative; each iteration the
    follower's state bitwise the leader's; an abort mid-trace frees
    every slot on both; stop_followers ends follow().  Returns the
    serving kernels' launches of the plain run and the iteration
    times."""
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.serving import harness

    trace = harness.serving_trace(40, cfg.vocab_size, seed=7)
    g = torch.Generator().manual_seed(17)
    dcfg = dataclasses.replace(cfg, n_layers=2)
    draft = tt.init_transformer(torch.Generator().manual_seed(1), dcfg,
                                device="cuda")
    out, launches = {}, None
    for label, kw in (("plain", {}),
                      ("speculative", {"draft": (draft, dcfg),
                                       "spec_tokens": 3})):
        leader, follower, box = _relayed_pair(engine_of, **kw)
        leader.warm_start()
        follower.warm_start()
        step = leader.step
        times = {"leader": [], "follower": []}
        checked = [0]

        def mirrored_step(*a, _step=step, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ran = _step(*a, **k)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if not follower.follow():
                raise AssertionError("follow() stopped mid-trace")
            torch.cuda.synchronize()
            times["leader"].append((t1 - t0) * 1e3)
            times["follower"].append((time.perf_counter() - t1) * 1e3)
            diff = "unread broadcasts" if box else _mirrored(leader,
                                                              follower)
            if diff:
                raise AssertionError(f"{label}: the follower differs from "
                                     f"the leader after iteration "
                                     f"{checked[0]}: {diff}")
            checked[0] += 1
            return ran

        leader.step = mirrored_step
        if label == "plain":
            S.reset_launches()
        run = harness.run_trace(leader, trace, True)
        if label == "plain":
            launches = dict(S.launches)
        pressure = serving_pressure(leader, cfg, g)
        # An abort mid-iteration stream: requests in flight, abort_all,
        # the follower's next reception is the marker.
        for i in range(8):
            leader.submit(trace[i]["prompt"], max_new_tokens=40)
        for _ in range(3):
            leader.step()
        failed = leader.abort_all()
        if not follower.follow() or box:
            raise AssertionError("the abort marker did not reach follow()")
        free = [c.free_pages() for c in (leader.cache, follower.cache)]
        if len(failed) != 8 or free != [leader.cache.n_pages - 1] * 2 or \
                (leader.cache._lengths >= 0).any() or \
                (follower.cache._lengths >= 0).any() or \
                _mirrored(leader, follower):
            raise AssertionError(f"{label}: after abort_all {len(failed)} "
                                 f"failed, free pages {free}")
        leader.stop_followers()
        if follower.follow() is not False or box:
            raise AssertionError("stop_followers did not end follow()")
        out[label] = {
            "iterations_mirrored": checked[0],
            "tokens": sum(len(t) for t in run["tokens"]),
            "leader_iteration_ms_p50": _pct(times["leader"], 0.5),
            "follower_iteration_ms_p50": _pct(times["follower"], 0.5),
            "leader_iteration_ms_mean": float(np.mean(times["leader"])),
            "follower_iteration_ms_mean": float(np.mean(times["follower"])),
            "abort_freed_both": True, "stop_followers_ended_follow": True,
            "pressure": pressure,
            **({"acceptance": leader.spec_acceptance_rate}
               if label == "speculative" else {})}
        del leader, follower
        torch.cuda.empty_cache()
    log({"phase": "serving_followers", "trace": "bench.py seed 7, 40 "
         "requests, continuous", **out, "launches_plain": launches})
    return out, launches


def serving_shard_kernels(S, cfg, g):
    """The serving kernels at the products and heads one rank of a model
    axis of 2 and 4 runs (column-parallel QKV and FFN-in with bf16 out,
    row-parallel wo and FFN-out with the f32 partials the closers sum):
    the Hopper form by the counters, within the allowance of the plain
    version at M 16 and 1024, row-invariant at every M of SERVING_ROWS,
    two runs bitwise, timed beside the bound and torch.matmul."""
    d, f = cfg.d_model, cfg.d_ff
    out = {}
    for tp in SHARD_AXES:
        for name, K, N, odt in (("qkv", d, 3 * d // tp, torch.bfloat16),
                                ("wo", d // tp, d, torch.float32),
                                ("w_in", d, f // tp, torch.bfloat16),
                                ("w_out", f // tp, d, torch.float32)):
            form, tile_n, split = S.serving_gemm_form(torch.bfloat16, K, N)
            if form != "sm90":
                raise AssertionError(f"axis {tp} {name}: {form} form")
            w = (torch.randn(K, N, generator=g) * K ** -0.5).cuda().bfloat16()
            x = torch.randn(1024, K, generator=g).cuda().bfloat16()
            full = S.serving_gemm(x, w, out_dtype=odt)
            differs = _first_differing(
                full, lambda m: S.serving_gemm(x[:m], w, out_dtype=odt),
                SERVING_ROWS)
            if differs:
                raise AssertionError(f"axis {tp} {name}: rows differ at M "
                                     f"{differs}")
            for M in (16, 1024):
                xm = x[:M]
                S.reset_launches()
                got = S.serving_gemm(xm, w, out_dtype=odt)
                again = S.serving_gemm(xm, w, out_dtype=odt)
                torch.cuda.synchronize()
                if S.launches_by_form[("serving_gemm", "sm90")] != 2:
                    raise AssertionError(f"axis {tp} {name}: launches by "
                                         f"form {S.launches_by_form}")
                if not torch.equal(got, again):
                    raise AssertionError(f"axis {tp} {name} M{M}: two runs "
                                         f"differ")
                allowed = (bf16_allowed if odt == torch.bfloat16
                           else _row_rms_allowed(SERVING_TOL_F32))
                err, margin = check(f"axis {tp} {name} M{M}", got,
                                    S.serving_gemm_plain(xm, w, odt),
                                    allowed)
                nbytes = (M * K + K * N) * 2 + M * N * (
                    2 if odt == torch.bfloat16 else 4)
                b_ms, b_by = bound(2.0 * M * N * K, nbytes, torch.bfloat16)
                ms = cuda_time_ms(lambda: S.serving_gemm(xm, w, odt),
                                  iters=20, queued=True)
                # f32 out: torch.matmul of f32 copies, made off the clock.
                xf, wf = ((xm, w) if odt == torch.bfloat16 else
                          (xm.float(), w.float()))
                lib = lambda: torch.matmul(xf, wf)  # noqa: E731
                out[f"tp{tp}_{name}_M{M}"] = {
                    "K": K, "N": N, "out": str(odt), "tile_n": tile_n,
                    "split": split, "ms": ms, "bound_ms": b_ms,
                    "bound_by": b_by, "share_of_bound": b_ms / ms,
                    "library_ms": cuda_time_ms(lib, iters=20, queued=True),
                    "max_abs_err": err, "worst_over_allowed": margin}
        # The attention at the shard's heads, decode and prefill shapes.
        H, hd, cap = cfg.n_heads // tp, d // cfg.n_heads, 1024
        q = torch.randn(1, 1024, H, hd, generator=g).cuda().bfloat16()
        k = torch.randn(1, cap, H, hd, generator=g).cuda().bfloat16()
        v = torch.randn(1, cap, H, hd, generator=g).cuda().bfloat16()
        pos = torch.arange(1024, device="cuda")[None]
        full = S.cache_attention(q, k, v, pos)[0]
        differs = _first_differing(
            full, lambda m: S.cache_attention(q[:, :m], k, v, pos[:, :m])[0],
            SERVING_ROWS)
        S.reset_launches()
        got = S.cache_attention(q, k, v, pos)
        if differs or S.launches_by_form[("cache_attention", "sm90")] != 1:
            raise AssertionError(f"axis {tp} attention: rows differ at "
                                 f"{differs}, {S.launches_by_form}")
        err, margin = check(f"axis {tp} attention", got,
                            S.cache_attention_plain(q, k, v, pos),
                            bf16_allowed)
        visible = int((pos + 1).clamp(0, cap).sum()) * H
        nbytes = (2 * 1024 * H * hd + 2 * cap * H * hd) * 2
        b_ms, b_by = bound(4.0 * visible * hd, nbytes, torch.bfloat16)
        ms = cuda_time_ms(lambda: S.cache_attention(q, k, v, pos), iters=20,
                          queued=True)
        # The library yardstick of the main case: SDPA in f32 with the
        # boolean mask of the rows' positions.
        mask = (torch.arange(cap, device="cuda")[None, None, None, :]
                <= pos[:, None, :, None])
        qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qf, kf, vf, attn_mask=mask), iters=20, queued=True)
        out[f"tp{tp}_attention_prefill"] = {
            "heads": H, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / ms, "library_ms": lib_ms,
            "max_abs_err": err, "worst_over_allowed": margin}
    for key, r in out.items():
        log({"phase": "serving_shard_kernel", "case": key, **r})
    return out


def serving_model_axis(cfg, params, engine_of, S, g):
    """A mesh engine at model axis 1 bitwise the plain engine; an axis of
    2 played in one process: prefill + decode bitwise the played
    serving_forward at 7 and 300 tokens, its logits within the
    single-device bf16 computation's own error of it (twice the per-row
    RMS distance of the single-device logits from the f32 forward of the
    same weights), and the greedy tokens' agreement reported."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.topology import make_mesh
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.utils.convert import serving_shard
    from horovod_tpu_torch.utils.tree import tree_map

    out = {}
    hvd.init(device="cuda")
    try:
        mesh = make_mesh(model=1)
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g)
                   .tolist() for n in (7, 300, 33)]
        rows = []
        for eng in (engine_of(), engine_of(mesh=mesh)):
            if eng.cache.page_sharding() is not None:
                raise AssertionError("a model axis of 1 sharded the pages")
            cap = _Capture(eng)
            reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
            eng.run_until_idle()
            rows.append(([r.result(0) for r in reqs],
                         [b"".join(x.tobytes() for x in cap.rows[r.rid])
                          for r in reqs]))
            del eng
        if rows[0] != rows[1]:
            raise AssertionError("the mesh engine at model axis 1 differs "
                                 "from the plain engine")
        out["axis1_bitwise_plain"] = True
    finally:
        hvd.shutdown()
    # The played axis of 2.
    tp, cap = 2, 1024
    shards = [serving_shard(params, cfg, i, tp) for i in range(tp)]
    hd = cfg.d_model // cfg.n_heads
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = tree_map(lambda x: x.float(), params)

    def views(b):
        return [torch.zeros((cfg.n_layers, b, cap, cfg.n_heads // tp, hd),
                            dtype=cfg.dtype, device="cuda")
                for _ in range(tp)]

    def played_forward(tokens):
        z = views(1)
        return tt.play_forward_step(shards, tokens, torch.zeros(
            (1,), dtype=torch.long, device="cuda"), z, z, cfg)[0][0]

    S.reset_launches()
    for n, new in ((7, 16), (300, 16)):
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=g).cuda()
        with torch.no_grad():
            kv = views(1), views(1)
            logits, kn, vn = tt.play_forward_step(
                shards, prompt[None], torch.zeros((1,), dtype=torch.long,
                                                  device="cuda"),
                kv[0], kv[1], cfg)
            for r in range(tp):
                kv[0][r][:, :, :n], kv[1][r][:, :, :n] = kn[r], vn[r]
            got, seq = [logits[0, -1]], prompt.tolist()
            for i in range(new - 1):
                seq.append(int(got[-1].argmax()))
                blk = torch.tensor([[seq[-1], 0]], device="cuda")
                logits, kn, vn = tt.play_forward_step(
                    shards, blk, torch.tensor([len(seq) - 1], device="cuda"),
                    kv[0], kv[1], cfg)
                for r in range(tp):
                    kv[0][r][:, :, len(seq) - 1] = kn[r][:, :, 0]
                    kv[1][r][:, :, len(seq) - 1] = vn[r][:, :, 0]
                got.append(logits[0, 0])
            toks = torch.tensor([seq], device="cuda")
            want = played_forward(toks)
            single = tt.serving_forward(params, toks, cfg, cap)[0]
            ref32 = tt.serving_forward(params32, toks, f32, cap)[0]
        for i, row in enumerate(got):
            if not torch.equal(row, want[n - 1 + i]):
                raise AssertionError(f"played axis {tp}, prompt {n}: row "
                                     f"{i} differs from serving_forward")

        def row_rms(x):
            return x.float().pow(2).mean(dim=-1).sqrt()

        dist_single = row_rms(single - ref32)
        dist_played = row_rms(want - single)
        worst = float((dist_played / (2 * dist_single).clamp_min(1e-30))
                      .max())
        if not worst <= 1.0:
            raise AssertionError(f"played axis {tp}, prompt {n}: logits "
                                 f"{worst} of the allowance from the "
                                 f"single-device engine's")
        out[f"played_axis{tp}_prompt{n}"] = {
            "rows_bitwise": len(got), "worst_over_allowed": worst,
            "max_abs_diff_single": float((want - single).abs().max()),
            "max_row_rms_single_vs_f32": float(dist_single.max()),
            "greedy_agreement": float(
                (want.argmax(-1) == single.argmax(-1)).float().mean())}
    out["played_launches"] = dict(S.launches)
    log({"phase": "serving_model_axis", **out})
    return out


def phase_serving_mp(fa, smi_line, out_dir):
    """The rest of serving on the card (ROADMAP A.4): the follower
    mirroring rank 0 bitwise, the serving kernels at the model axis's
    shard shapes, an axis of 1 on a mesh and an axis of 2 played."""
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import serving as S
    from horovod_tpu_torch.serving import InferenceEngine
    from horovod_tpu_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = transformer_lm.bench_config()
    params = tree_map(lambda x: x.detach(), tt.init_transformer(
        torch.Generator().manual_seed(0), cfg, device="cuda"))
    g = torch.Generator().manual_seed(16)

    def engine_of(params=params, **kw):
        return InferenceEngine(params, cfg, device="cuda", max_slots=8,
                               page_size=16, capacity=1024, **kw)

    followers, launches = serving_followers(cfg, params, engine_of, S)
    shards = serving_shard_kernels(S, cfg, g)
    axis = serving_model_axis(cfg, params, engine_of, S, g)
    for name in S.KERNELS:
        for path, counts in (("follower", launches),
                             ("played_axis", axis["played_launches"])):
            if not counts.get(name):
                raise AssertionError(f"{name} never launched on the "
                                     f"{path} path: {counts}")
    log({"phase": "serving_mp", "device": smi_line,
         "seconds": time.perf_counter() - t_phase})
    return {"followers": followers, "launches": launches, "shards": shards,
            "axis": axis}


def phase_distill(fa, smi_line, out_dir):
    """examples/distill_draft.py on the card: GPT-2-small's serving
    checkpoint exported, its half-size draft distilled (20 steps, batch
    8, seq 1024; each flash kernel 6 times a step, the sm90 forms in a
    profiled step of the returned train step), exported, loaded by serve_lm's path (--draft) and
    served: the speculative tokens bitwise plain decode's."""
    import shutil

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import distill_draft, transformer_lm
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.serving import InferenceEngine
    from horovod_tpu_torch.utils import checkpoint as ck
    from horovod_tpu_torch.utils.tree import tree_map

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    steps, batch, seq = 20, 8, 1024
    cfg = transformer_lm.bench_config()
    files = os.path.join(out_dir, "distill_ckpt")
    shutil.rmtree(files, ignore_errors=True)
    hvd.init(device="cuda")
    try:
        params = tree_map(lambda x: x.detach(), tt.init_transformer(
            torch.Generator().manual_seed(0), cfg, device="cuda"))
        ck.save_serving_checkpoint(os.path.join(files, "target"), params,
                                   cfg, block=True)
        tparams, tcfg, meta = ck.load_serving_checkpoint(
            os.path.join(files, "target"))
        fa.reset_launches()
        run = distill_draft.distill(tparams, tcfg, steps=steps, batch=batch,
                                    seq=seq)
        launches = dict(fa.launches)
        dcfg = run["cfg"]
        losses = run["losses"]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"distill loss not finite and falling: "
                                 f"{losses}")
        # The backward kernels run only in the train steps; the forward
        # also in the teacher's and the held-out forwards.
        if any(launches[k] != steps * dcfg.n_layers
               for k in ("flash_bwd_dkdv", "flash_bwd_dq")) or \
                launches["flash_fwd"] < steps * dcfg.n_layers:
            raise AssertionError(f"distill's {steps} steps launched "
                                 f"{launches}")
        # Further steps of distill's own train step, timed one by one.
        step, data = run["step"], run["last_batch"]
        per_step, times = [], []
        for _ in range(6):
            torch.cuda.synchronize()
            fa.reset_launches()
            t0 = time.perf_counter()
            step(run["params"], data)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            per_step.append(dict(fa.launches))
        if any(c != {k: dcfg.n_layers for k in fa.KERNELS}
               for c in per_step):
            raise AssertionError(f"each flash kernel must launch "
                                 f"{dcfg.n_layers} times a step: {per_step}")
        prof = profile_step(lambda: step(run["params"], data), out_dir,
                            "distill")
        names = " ".join(prof["flash_kernels"])
        for want in ("flash_fwd_sm90_kernel", "flash_bwd_dkdv_sm90_kernel",
                     "flash_bwd_dq_sm90_kernel"):
            ran = sum(n for name, n in prof["flash_kernels"].items()
                      if want in name)
            if not 1 <= ran <= dcfg.n_layers:
                raise AssertionError(f"the profiled distill step ran {want} "
                                     f"{ran} times: {names}")
        for first_form in ("flash_fwd_kernel<", "flash_bwd_dkdv_kernel<",
                           "flash_bwd_dq_kernel<"):
            if first_form in names:
                raise AssertionError(f"the distill step ran {first_form}")
        ck.save_serving_checkpoint(os.path.join(files, "draft"),
                                   run["params"], dcfg,
                                   tokenizer=meta["tokenizer"]["kind"],
                                   block=True)
    finally:
        hvd.shutdown()
    # serve_lm's --draft path: both exports loaded from their files.
    tparams, tcfg, _ = ck.load_serving_checkpoint(
        os.path.join(files, "target"))
    dparams, dcfg2, _ = ck.load_serving_checkpoint(
        os.path.join(files, "draft"))
    shutil.rmtree(files, ignore_errors=True)
    if dcfg2 != dcfg or (dcfg.d_model, dcfg.n_heads, dcfg.n_layers,
                         dcfg.d_ff) != (384, 6, 6, 1536):
        raise AssertionError(f"draft config {dcfg2}")
    g = torch.Generator().manual_seed(70)
    prompts = [torch.randint(0, tcfg.vocab_size, (n,), generator=g).tolist()
               for n in (9, 100, 400)]

    def engine(**kw):
        return InferenceEngine(tparams, tcfg, device="cuda", max_slots=8,
                               page_size=16, capacity=1024, **kw)

    plain = engine()
    want = [plain.generate(p, max_new_tokens=24) for p in prompts]
    del plain
    spec = engine(draft=(dparams, dcfg2), spec_tokens=3)
    spec.warm_start()
    reqs = [spec.submit(p, max_new_tokens=24) for p in prompts]
    spec.run_until_idle()
    got = [r.result(0) for r in reqs]
    if got != want:
        raise AssertionError("the distilled draft's speculative tokens "
                             "differ from plain decode")
    out = {"steps": steps, "batch": batch, "seq": seq, "losses": losses,
           "step_ms_mean": float(np.mean(times[1:])),
           "launches_per_step": per_step[-1], "launches_in_distill": launches,
           "held_out_greedy_agreement": run["agreement"],
           "spec_acceptance": spec.spec_acceptance_rate,
           "speculative_bitwise_plain": True,
           "teacher_params": run["teacher_params"],
           "draft_params": run["draft_params"],
           "profiled_step": {k: prof[k] for k in (
               "profiled_step_ms", "device_busy_ms", "device_idle_share",
               "flash_kernels")},
           "seconds": time.perf_counter() - t_phase}
    log({"phase": "distill", "device": smi_line, **out})
    return {"launches": launches, **out}


OBSERVE_ENV = {"HVD_TPU_LOCK_CHECK": "1", "HVD_TPU_RACE_CHECK": "1",
               "HVD_TPU_VERIFY_PROGRAM": "1", "HVD_TPU_TRACE": "1"}


def _digest_tensors(tensors) -> str:
    """sha256 over the bytes of ``tensors`` in order (bitwise identity of
    two runs' weights or optimizer moments without keeping a copy)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous()
        h.update(str((tuple(t.shape), str(t.dtype))).encode())
        h.update(t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _observe_hook_run(hvd, fa, steps=3, tracer=True):
    """GPT-2-small's hook-driven AdamW step (examples/transformer_lm.py,
    bf16, batch 8, seq 1024) from seed 0, ``steps`` steps with the tracer
    on or off: the losses, the digests of the weights and of AdamW's
    moments, each flash kernel's launches a step, and the run for more
    steps."""
    from horovod_tpu_torch import trace
    from horovod_tpu_torch.analysis import program
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.utils.tree import tree_leaves

    cfg = transformer_lm.bench_config()
    run = transformer_lm.train(cfg, batch=8, seq=1024, steps=0,
                               device="cuda", seed=0, hooks=True)
    trace.set_enabled(tracer)  # after init, whose reset_run re-reads env
    losses, per_step = [], []
    for i in range(steps):
        if i == steps - 1:
            program.recorder().clear()  # verify_program sees one step
        before = dict(fa.launches)
        losses.append(float(run["step"](run["params"], run["data"])))
        per_step.append({k: n - before[k] for k, n in fa.launches.items()})
    torch.cuda.synchronize()
    leaves = tree_leaves(run["params"])
    state = run["optimizer"].state
    moments = [state[p][k] for p in leaves for k in ("exp_avg",
                                                     "exp_avg_sq")]
    for launches in per_step:
        if any(n != cfg.n_layers for n in launches.values()):
            raise AssertionError(f"each flash kernel must launch "
                                 f"{cfg.n_layers} times a step: {per_step}")
    return {"losses": losses, "weights": _digest_tensors(leaves),
            "moments": _digest_tensors(moments),
            "launches_per_step": per_step}, run, cfg


def observe_child(result_path, out_dir) -> int:
    """The observe phase's checkers-on leg, in a process of its own (the
    checkers arm at import and lock creation): 3 hook steps under
    HVD_TPU_LOCK_CHECK, HVD_TPU_RACE_CHECK, HVD_TPU_VERIFY_PROGRAM and
    the tracer; verify_program, the race checker's count, the step's
    trace decomposition and one profiled step's sm90 kernels."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import trace
    from horovod_tpu_torch.analysis import lockorder, program, races
    from horovod_tpu_torch.core import state
    from horovod_tpu_torch.ops import _build, cache as cache_mod
    from horovod_tpu_torch.ops import collective
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.trace import analyze as tanalyze

    _build.build_all()
    if not (lockorder.enabled() and races.enabled()
            and program.program_check_enabled() and trace.enabled()):
        raise AssertionError("the checkers-on leg runs without its checkers")
    if not isinstance(collective.Runtime.__dict__.get("_ops"),
                      races._TrackedField):
        raise AssertionError("Runtime is not race-checked")
    res, run, cfg = _observe_hook_run(hvd, fa)
    rt = state._state.runtime
    if not isinstance(rt._lock, lockorder.CheckedLock) or \
            rt.cache is not None or cache_mod.cache_enabled():
        raise AssertionError("checked locks, or the cache off under the "
                             "program tracker: not so")
    report = hvd.verify_program()
    step = trace.current_step()
    events = [e for e in trace.export_events()
              if (e.get("args") or {}).get("step") == step]
    decomposition = tanalyze.analyze(events)
    prof = profile_step(lambda: run["step"](run["params"], run["data"]),
                        out_dir, "observe_checkers")
    for want in ("flash_fwd_sm90_kernel", "flash_bwd_dkdv_sm90_kernel",
                 "flash_bwd_dq_sm90_kernel"):
        ran = sum(n for name, n in prof["flash_kernels"].items()
                  if want in name)
        if ran != cfg.n_layers:
            raise AssertionError(f"the profiled checkers-on step ran {want} "
                                 f"{ran} times: {prof['flash_kernels']}")
    res.update(
        verify_program={"ranks": report.ranks, "entries": report.entries,
                        "digest": report.digest},
        race_checks=races.check_count(),
        lock_order_edges=sum(len(v) for v in
                             lockorder.graph_snapshot().values()),
        trace_step=step, trace_spans=len(events),
        step_decomposition_us=decomposition["attribution_us"],
        step_spans={name: sum(1 for e in events if e["name"] == name)
                    for name in sorted({e["name"] for e in events})},
        profiled_flash_kernels=prof["flash_kernels"])
    del run
    hvd.shutdown()
    with open(result_path, "w") as f:
        json.dump(res, f)
    return 0


def _served_trace(eng, cap, trace_reqs, tracer_on):
    """bench.py's trace through ``eng`` with the tracer on or off: the
    tokens, the iterations that ran work, the serving.iteration spans
    and the decode-iteration times (``cap``, the engine's _Capture)."""
    from horovod_tpu_torch import trace
    from horovod_tpu_torch.serving import harness

    trace.set_enabled(tracer_on)
    trace.clear()
    cap.rows.clear()
    cap.times["decode"].clear()
    worked = [0]
    step = eng.step

    def counting(*a, **kw):
        ran = step(*a, **kw)
        worked[0] += bool(ran)
        return ran

    eng.step = counting
    try:
        run = harness.run_trace(eng, trace_reqs, True)
    finally:
        eng.step = step
        trace.set_enabled(True)
    spans = [e for e in trace.export_events()
             if e.get("name") == "serving.iteration"]
    return {"tokens": run["tokens"], "worked": worked[0],
            "spans": len(spans), "iterations": run["iterations"],
            "decode_ms_p50": _pct(cap.times["decode"], 0.5),
            "seconds": run["seconds"]}


def _observe_plans_and_oom(hvd, cfg, engine_of, out_dir, out):
    """(c) and (d) of the observe phase, which time nothing, so they run
    beside the checkers-on child: the KV pool against plan_serving and
    the ledger, the prefix and draft what-ifs, the simulated and the real
    out-of-memory through guard, the f32 training plan against the card
    and one more step after the out-of-memory."""
    import shutil

    from horovod_tpu_torch.examples import distill_draft, transformer_lm
    from horovod_tpu_torch.memory import ledger as mledger
    from horovod_tpu_torch.memory import oom, planner
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.telemetry import flight
    from horovod_tpu_torch.utils.tree import tree_leaves, tree_map

    eng = engine_of()
    eng.warm_start()
    # (c) The KV pool: the plan, the engine and the ledger, exactly.
    kv_plan = planner.plan_serving(
        n_layers=12, n_heads=12, head_dim=64, max_slots=8,
        pages_per_slot=64, page_size=16, dtype="bfloat16",
        vocab_size=cfg.vocab_size)
    pool = eng.cache.k_pages.nbytes + eng.cache.v_pages.nbytes
    led_kv = mledger.ledger.bytes_by_category().get("serving.kv_pages")
    if not (kv_plan.framework["serving.kv_pages"] == pool == led_kv
            == 302_579_712):
        raise AssertionError(f"KV pool: plan "
                             f"{kv_plan.framework['serving.kv_pages']}, "
                             f"engine {pool}, ledger {led_kv}")
    dcfg = distill_draft.draft_config(cfg)
    dparams = tree_map(lambda x: x.detach(), tt.init_transformer(
        torch.Generator().manual_seed(1), dcfg, device="cuda"))
    deng = engine_of(draft=(dparams, dcfg), prefix_pages=64)
    what_if = planner.plan_serving(
        n_layers=12, n_heads=12, head_dim=64, max_slots=8,
        pages_per_slot=64, page_size=16, dtype="bfloat16",
        prefix_pages=64, draft_layers=6, vocab_size=cfg.vocab_size)
    cats = mledger.ledger.bytes_by_category()
    out["kv_plan"] = {
        "serving.kv_pages": {"plan": kv_plan.framework["serving.kv_pages"],
                             "engine": pool, "ledger": led_kv},
        "what_if_prefix_pages_64": what_if.framework["serving.prefix_pages"],
        "engine_prefix_pages_64": deng.cache.prefix_pages
        * deng.cache._page_resident_bytes,
        "what_if_draft_layers_6": {
            "serving.draft_kv": what_if.framework["serving.draft_kv"],
            "serving.draft_params": what_if.framework[
                "serving.draft_params"]},
        "draft_engine": {
            "config": {"d_model": dcfg.d_model, "n_heads": dcfg.n_heads,
                       "n_layers": dcfg.n_layers, "d_ff": dcfg.d_ff},
            "draft_kv": deng.draft_cache.k_pages.nbytes
            + deng.draft_cache.v_pages.nbytes,
            "ledger_draft_kv": cats.get("serving.draft_kv"),
            "ledger_draft_params": cats.get("serving.draft_params")}}
    del deng, dparams
    gc.collect()
    torch.cuda.empty_cache()

    # (d) A simulated OOM on a serving decode, then a real one.
    fdir = os.path.join(out_dir, "observe_flight")
    shutil.rmtree(fdir, ignore_errors=True)
    os.environ["HVD_TPU_FLIGHT_DIR"] = fdir
    try:
        flight.recorder._last_dump.pop("oom", None)
        eng.submit(list(range(1, 30)), max_new_tokens=8)
        eng.step()  # the prefill and the first decode, within capacity
        total = mledger.ledger.total()
        os.environ[oom.CAPACITY_ENV] = str(total - 4096)
        try:
            eng.step()
            raise AssertionError("no simulated OOM under the capacity")
        except oom.ResourceExhaustedError as e:
            sim_msg = str(e)
        finally:
            os.environ.pop(oom.CAPACITY_ENV, None)
        eng.abort_all()
        dumps = sorted(f for f in os.listdir(fdir) if "oom" in f)
        with open(os.path.join(fdir, dumps[-1])) as f:
            sim = json.load(f)["extra"]
        top = [t["category"] for t in sim["top_categories"]]
        if sim["executable"] != "serving/decode" or \
                "serving.kv_pages" not in top:
            raise AssertionError(f"the simulated OOM's dump: {sim}")
        out["simulated_oom"] = {"message": sim_msg[:200],
                                "executable": sim["executable"],
                                "top_categories": sim["top_categories"],
                                "ledger_total_bytes": total}
        # A real out-of-memory inside guard: the same object re-raised.
        known = (eng.cache.k_pages.nbytes + eng.cache.v_pages.nbytes
                 + sum(x.untyped_storage().nbytes()
                       for x in {t.untyped_storage().data_ptr(): t for t in
                                 tree_leaves([eng.params,
                                              eng._step_params])}.values()))
        total_card = torch.cuda.mem_get_info()[1]
        flight.recorder._last_dump.pop("oom", None)
        inner = {}
        try:
            with oom.guard("oom_probe"):
                try:
                    torch.empty(total_card + (1 << 20), dtype=torch.uint8,
                                device="cuda")
                except torch.cuda.OutOfMemoryError as e:
                    inner["exc"] = e
                    raise
            raise AssertionError("no out-of-memory for more than the card")
        except torch.cuda.OutOfMemoryError as e:
            if e is not inner.get("exc"):
                raise AssertionError("guard did not re-raise the same "
                                     "object")
        allocated = torch.cuda.memory_allocated()
        dumps = sorted(f for f in os.listdir(fdir) if "oom" in f)
        with open(os.path.join(fdir, dumps[-1])) as f:
            real = json.load(f)["extra"]
        stats, live = real["device_memory_stats"], real["live_arrays"]
        if real["executable"] != "oom_probe" or not stats or \
                stats["bytes_limit"] != total_card or \
                not known <= live["live_bytes"] <= allocated:
            raise AssertionError(f"the real OOM's dump: {real['executable']}"
                                 f" stats {stats}, live "
                                 f"{live['live_bytes']}, known {known}, "
                                 f"allocated {allocated}")
        out["real_oom"] = {"error": real["error"][:160],
                           "device_memory_stats": stats,
                           "live_bytes": live["live_bytes"],
                           "live_tensors": live["arrays"],
                           "known_bytes": known,
                           "memory_allocated": allocated,
                           "top_live": live["top"][:4]}
    finally:
        os.environ.pop("HVD_TPU_FLIGHT_DIR", None)

    # (c) The trainer's plan against the card: f32, AdamW.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    run = transformer_lm.train(cfg32, batch=8, seq=1024, steps=1,
                               device="cuda", seed=0, hooks=True)
    plan = planner.plan_transformer_lm(
        vocab_size=32768, d_model=768, n_heads=12, n_layers=12, d_ff=3072,
        max_seq_len=1024, batch_size=8, dtype="float32", optimizer="adam")
    leaves = tree_leaves(run["params"])
    p_bytes = sum(p.nbytes for p in leaves)
    state = run["optimizer"].state
    m_bytes = sum(state[p][k].nbytes for p in leaves
                  for k in ("exp_avg", "exp_avg_sq"))
    if plan.sections["params"] != p_bytes or p_bytes != 544_548_864 or \
            plan.sections["optimizer_state"] != m_bytes:
        raise AssertionError(f"plan params {plan.sections['params']} vs "
                             f"{p_bytes}, optimizer "
                             f"{plan.sections['optimizer_state']} vs "
                             f"{m_bytes}")
    mledger.ledger.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    run["step"](run["params"], run["data"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out["train_plan"] = {
        "plan_sections": plan.sections, "plan_framework": plan.framework,
        "plan_per_rank_bytes": plan.per_rank_bytes,
        "params_bytes": p_bytes, "adamw_moment_bytes": m_bytes,
        "allocated_before_step": before, "max_memory_allocated_step": peak,
        "plan_over_peak": plan.per_rank_bytes / peak,
        "logits_f32_bytes": 8 * 1024 * 32768 * 4,
        "ledger_peak_by_category": mledger.ledger.peak_by_category(),
        "ledger_step_watermark": mledger.ledger.step_watermark()}
    # (d, end) The card is usable after the out-of-memory: one more step.
    loss = float(run["step"](run["params"], run["data"]))
    if not np.isfinite(loss):
        raise AssertionError(f"the step after the OOM: loss {loss}")
    out["step_after_oom_loss"] = loss
    del run
    hvd.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return eng


def phase_observe(fa, smi_line, out_dir):
    """The analysis, trace and memory tooling (ROADMAP A.5.2) on the
    card, five legs at GPT-2-small's full width.  (a) 3 hook-driven
    AdamW steps in a child process under HVD_TPU_LOCK_CHECK,
    HVD_TPU_RACE_CHECK, HVD_TPU_VERIFY_PROGRAM and the tracer, bitwise
    the same 3 steps here with all of them off (losses, weights, AdamW's
    moments); each flash kernel 12 times a step (and the sm90 forms in
    the child's profiled step); no LockOrderError or DataRaceError;
    verify_program's report; the step's trace decomposition; the hook
    step with the tracer on and off in turns.  (b) bench.py's trace (40
    requests) served with the tracer on, bitwise the tracer-off tokens,
    one serving span per iteration that ran work; the decode iteration's
    p50 with the tracer on and off in turns.  (c) plan_transformer_lm at
    f32/adam against the port's own tensors (parameters and AdamW's
    moments exactly), the plan's total against the allocator's peak over
    one step, the ledger's categories; plan_serving against the engine's
    KV pool and the ledger's serving.kv_pages exactly; the prefix and
    draft what-ifs beside a draft engine's cache.  (d) a simulated OOM
    through guard on a serving decode, a real torch.cuda.OutOfMemoryError
    inside guard re-raised as the same object with the allocator's
    figures and a live sweep in its dump, then one more training step.
    (e) the lint gate over the package, as a subprocess.  The child and
    the lint gate run while (c) and (d), which time nothing, run here;
    the timed legs start after both have ended."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import trace
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import serving as S
    from horovod_tpu_torch.serving import InferenceEngine, harness
    from horovod_tpu_torch.utils.tree import tree_map

    gc.collect()  # engines of earlier phases leave the ledger
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out = {}
    launches = {}
    # (a, e) The checkers-on child and the lint gate, started now.
    child_json = os.path.join(out_dir, "observe_child.json")
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--observe-child",
         child_json, "--out-dir", out_dir], env={**os.environ,
                                                 **OBSERVE_ENV},
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lint = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.analysis", "--strict",
         "horovod_tpu_torch"], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        cfg = transformer_lm.bench_config()
        params = tree_map(lambda x: x.detach(), tt.init_transformer(
            torch.Generator().manual_seed(0), cfg, device="cuda"))

        def engine_of(**kw):
            return InferenceEngine(params, cfg, device="cuda", max_slots=8,
                                   page_size=16, capacity=1024, **kw)

        fa.reset_launches()
        S.reset_launches()
        eng = _observe_plans_and_oom(hvd, cfg, engine_of, out_dir, out)
        _, child_err = child.communicate(timeout=300)
        lint_out, lint_err = lint.communicate(timeout=300)
    finally:
        for proc in (child, lint):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    child_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"the checkers-on leg failed (rc "
                             f"{child.returncode}): {child_err[-3000:]}")
    if lint.returncode != 0:
        raise AssertionError(f"the lint gate: rc {lint.returncode}\n"
                             f"{lint_out[-3000:]}{lint_err[-500:]}")
    out["lint"] = lint_err.strip().splitlines()[-1]
    with open(child_json) as f:
        on = json.load(f)

    # (a) The same 3 steps here, with every checker and the tracer off.
    fa.reset_launches()
    S.reset_launches()
    off, run, cfg = _observe_hook_run(hvd, fa, tracer=False)
    if trace.enabled():
        raise AssertionError("the checkers-off leg ran with the tracer on")
    trace.set_enabled(True)
    for key in ("losses", "weights", "moments", "launches_per_step"):
        if on[key] != off[key]:
            raise AssertionError(f"checkers on and off differ in {key}: "
                                 f"{on[key]} against {off[key]}")
    n_sig = on["verify_program"]["entries"]
    if on["verify_program"]["ranks"] != 1 or n_sig != 18:
        raise AssertionError(f"verify_program: {on['verify_program']} "
                             f"(18 tensors a step: 17 gradients, the loss)")
    if on["race_checks"] <= 0:
        raise AssertionError("the race checker verified nothing")
    out["checkers"] = {k: on[k] for k in (
        "losses", "verify_program", "race_checks", "lock_order_edges",
        "trace_step", "trace_spans", "step_spans", "step_decomposition_us",
        "profiled_flash_kernels")}
    out["checkers"]["child_and_lint_seconds"] = child_s
    out["checkers"]["bitwise_checkers_off"] = True
    # The hook step, tracer on and off in turns (5 pairs, 3 steps each).
    ms = {"on": [], "off": []}
    for tracer_on in (True, False, False, True) * 2 + (True, False):
        trace.set_enabled(tracer_on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            run["step"](run["params"], run["data"])
        torch.cuda.synchronize()
        ms["on" if tracer_on else "off"].append(
            (time.perf_counter() - t0) / 3e-3)
    trace.set_enabled(True)
    out["hook_step_ms_tracer_on"] = ms["on"]
    out["hook_step_ms_tracer_off"] = ms["off"]
    launches["hook"] = dict(fa.launches)
    if any(n != cfg.n_layers * 33 for n in launches["hook"].values()):
        raise AssertionError(f"33 hook steps: {launches['hook']}")
    del run
    hvd.shutdown()
    torch.cuda.empty_cache()

    # (b) The served leg, on the engine (c) and (d) used.
    trace_reqs = harness.serving_trace(40, cfg.vocab_size, seed=7)
    for n in (4, 16):  # the trace's prefill buckets, off the clock
        eng.generate(list(range(1, n + 1)), max_new_tokens=2)
    cap = _Capture(eng)
    runs = {"on": [], "off": []}
    for tracer_on in (True, False, False, True) * 2 + (True, False):
        r = _served_trace(eng, cap, trace_reqs, tracer_on)
        runs["on" if tracer_on else "off"].append(r)
    tokens = runs["on"][0]["tokens"]
    for r in runs["on"] + runs["off"]:
        if r["tokens"] != tokens:
            raise AssertionError("the traced served tokens differ from the "
                                 "untraced")
    for r in runs["on"]:
        if r["spans"] != r["worked"] or not r["worked"]:
            raise AssertionError(f"{r['spans']} serving spans for "
                                 f"{r['worked']} iterations")
    if any(r["spans"] for r in runs["off"]):
        raise AssertionError("serving spans with the tracer off")
    out["served"] = {
        "requests": len(trace_reqs),
        "tokens": sum(len(t) for t in tokens),
        "iterations_with_work": runs["on"][0]["worked"],
        "serving_spans": runs["on"][0]["spans"],
        "decode_ms_p50_tracer_on": [r["decode_ms_p50"] for r in runs["on"]],
        "decode_ms_p50_tracer_off": [r["decode_ms_p50"]
                                     for r in runs["off"]],
        "trace_seconds_on": [r["seconds"] for r in runs["on"]],
        "trace_seconds_off": [r["seconds"] for r in runs["off"]],
        "bitwise_tracer_off": True}
    launches["served"] = dict(S.launches)
    if not all(launches["served"].get(name) for name in S.KERNELS):
        raise AssertionError(f"the served leg: {launches['served']}")
    del eng, cap, params
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log({"phase": "observe", "device": smi_line, **out})
    return {"launches": launches, **out}


# elastic phase: elastic training and serving (ROADMAP A.5.3) and the
# chaos sites the port hosts (A.5.4, first half).

ELASTIC_STEPS = 8          # GPT-2-small steps of the elastic training leg
ELASTIC_COMMIT_EVERY = 2   # a commit after every second step
ELASTIC_DIE_AT = 5         # the first incarnation dies before this step
ELASTIC_SERVE_DRAIN_AT = 20  # trace iterations before the drain_commit
ELASTIC_HTTP_DRAIN_AT = 6  # decode iterations before POST /drain
ELASTIC_HTTP_REQUESTS = 8
ELASTIC_FAULTS = "ckpt.oserror:count=2@7"


def _process_start_time() -> float:
    """This process's start on the wall clock: its start tick after boot
    (/proc, 10 ms resolution) against the boot clock now."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    since_start = (time.clock_gettime(time.CLOCK_BOOTTIME)
                   - ticks / os.sysconf("SC_CLK_TCK"))
    return time.time() - since_start


def _trainer_digests(trainer) -> dict:
    """sha256 of the trainer's parameters and of AdamW's state (moments
    and step counts, parameters in order, keys sorted)."""
    from horovod_tpu_torch.utils.tree import tree_leaves

    opt = trainer.optimizer.state_dict()["state"]
    return {"params": _digest_tensors(tree_leaves(trainer.params)),
            "adamw": _digest_tensors([st[k] for _, st in sorted(opt.items())
                                   for k in sorted(st)
                                   if isinstance(st[k], torch.Tensor)])}


def elastic_train_child(mode, result_path, die_at) -> int:
    """One incarnation of the elastic training leg, run by the elastic
    launcher (``python -m horovod_tpu_torch.run --elastic -np 1 ...
    chip_smoke.py --elastic-child MODE``): GPT-2-small (bf16, batch 8, seq
    1024, AdamW) through ``Trainer`` and ``TrainerState`` under
    ``@elastic.run``, ELASTIC_STEPS steps, a commit every
    ELASTIC_COMMIT_EVERY.  ``die_at``: the first incarnation waits for
    its last commit to be durable, then dies hard (``os._exit``) before
    that step.  ``mode`` "retry": one ``HorovodError`` after step 5, in
    process.  Appends one JSON line per incarnation to ``result_path``."""
    t_proc = _process_start_time()
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.frontends.loop import Trainer
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops.collective import HorovodError
    from horovod_tpu_torch.utils import checkpoint as ck
    from horovod_tpu_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device="cuda")
    cfg = transformer_lm.bench_config()
    batch, seq = 8, 1024
    trainer = Trainer(
        tt.make_loss_fn(cfg), tt.init_transformer(
            torch.Generator().manual_seed(0), cfg, device="cuda"),
        optimizer_fn=torch.optim.AdamW, lr=3e-4,
        optimizer_kwargs={"weight_decay": 1e-4, "foreach": True})
    state = elastic.TrainerState(trainer, step=0)
    edir = os.environ["HVD_TPU_ELASTIC_DIR"]
    marker = os.path.join(edir, "chip_smoke_died")
    rec = {"mode": mode, "pid": os.getpid(), "t_process_start": t_proc}
    torch.cuda.synchronize()
    rec["t_init_done"] = time.time()
    stamps = {}

    def batches(epoch, _step):
        # The data of a step is made from the step, as in the reference.
        return tt.synthetic_lm_batch(torch.Generator().manual_seed(
            1000 + epoch), batch, seq, cfg.vocab_size)

    def reset():
        stamps["t_rolled_back"] = time.time()

    state.register_reset_callbacks([reset])

    @elastic.run
    def train(state):
        torch.cuda.synchronize()
        stamps.setdefault("t_entered", time.time())
        if "t_rolled_back" in stamps and "t_reentered" not in stamps:
            stamps["t_reentered"] = time.time()
        rec.setdefault("start_step", state.step)
        fa.reset_launches()
        steps_run = 0
        while state.step < ELASTIC_STEPS:
            i = state.step
            if die_at is not None and i == die_at and \
                    not os.path.exists(marker):
                t0 = time.time()
                assert state.wait_committed(120.0)
                rec["wait_committed_s"] = time.time() - t0
                rec["write_seconds"] = dict(
                    ck.stats()["checkpoint.write_seconds"])
                rec["retries"] = ck.stats()["checkpoint.retries"]
                rec["flash_launches"] = dict(fa.launches)
                rec["steps_run"] = steps_run
                open(marker, "w").close()
                rec["t_death"] = time.time()
                with open(result_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                os._exit(1)  # a hard failure: no handshake
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.fit(batches, epochs=i + 1, steps_per_epoch=1,
                        initial_epoch=i, prefetch=0)
            torch.cuda.synchronize()
            rec.setdefault("step_ms", []).append(
                (time.perf_counter() - t0) * 1e3)
            steps_run += 1
            state.step += 1
            if mode == "retry" and state.step == 6 and \
                    "t_raised" not in stamps:
                stamps["t_raised"] = time.time()
                raise HorovodError("injected transient failure at step 5")
            if state.step % ELASTIC_COMMIT_EVERY == 0:
                t0 = time.perf_counter()
                state.commit()
                rec.setdefault("commit_ms", []).append(
                    (time.perf_counter() - t0) * 1e3)
        rec["flash_launches"] = dict(fa.launches)
        rec["steps_run"] = steps_run
        return trainer

    t_call = time.time()
    train(state)
    assert state.wait_committed(120.0)
    rec.update(stamps)
    rec["t_call"] = t_call
    rec["sync_ms"] = (stamps["t_entered"] - t_call) * 1e3
    rec["snapshot_bytes"] = sum(
        x.numel() * x.element_size() for x in tree_leaves(state._snapshot)
        if isinstance(x, torch.Tensor))
    rec["write_seconds"] = dict(ck.stats()["checkpoint.write_seconds"])
    rec["retries"] = ck.stats()["checkpoint.retries"]
    rec["file_bytes"] = os.path.getsize(os.path.join(edir, elastic._STATE_FILE))
    rec["digests"] = _trainer_digests(trainer)
    rec["final_step"] = state.step
    rec["losses"] = [h["loss"] for h in trainer.history]
    with open(result_path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    hvd.shutdown()
    return 0


def _elastic_launch(args, edir, result, env=None):
    """Start ``chip_smoke.py --elastic-child ...`` under ``python -m
    horovod_tpu_torch.run --elastic -np 1``: the launcher, the thread
    that stamps each of its output lines with the wall time it arrived,
    and those lines (:func:`_elastic_finish` waits for it)."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "--elastic",
           "-np", "1", "--max-restarts", "2", "--elastic-dir", edir,
           os.path.abspath(__file__), "--elastic-child", *args,
           "--elastic-result", result]
    proc = subprocess.Popen(cmd, cwd=HERE, env={**os.environ, **(env or {})},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    lines = []

    def pump():
        for line in proc.stdout:
            lines.append((time.time(), line.rstrip("\n")))

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return proc, t, lines


def _elastic_finish(run, result, what, timeout=300):
    """Wait for a launch; returns its stamped lines and the child's JSON
    records, one per incarnation."""
    proc, t, lines = run
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:  # the launcher and its workers
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    t.join(10.0)
    if rc != 0:
        tail = "\n".join(line for _, line in lines[-40:])
        raise AssertionError(f"elastic {what}: the launcher exited {rc}\n"
                             f"{tail}")
    with open(result) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return lines, recs


def elastic_serve_child(result_path, payload_path) -> int:
    """The relaunched serving incarnation: a fresh GPT-2-small engine
    (the same seed-0 weights) syncs the ServingState commit and finishes
    the drained trace; a fresh LMServer takes the HTTP leg's /drain
    payload through POST /resume.  Writes one JSON object."""
    t_proc = _process_start_time()
    import urllib.request

    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import serving as S
    from horovod_tpu_torch.serving import InferenceEngine
    from horovod_tpu_torch.serving.server import LMServer
    from horovod_tpu_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = transformer_lm.bench_config()
    params = tree_map(lambda x: x.detach(), tt.init_transformer(
        torch.Generator().manual_seed(0), cfg, device="cuda"))

    def engine_of():
        return InferenceEngine(params, cfg, device="cuda", max_slots=8,
                               page_size=16, capacity=1024)

    out = {"t_process_start": t_proc}
    eng = engine_of()
    eng.warm_start()
    S.reset_launches()
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = elastic.ServingState(eng)
    state.sync()
    out["sync_ms"] = (time.perf_counter() - t0) * 1e3
    pend = eng.scheduler.pending()
    eng.run_until_idle()
    out["state"] = [{"prompt": r.prompt[:len(r.prompt) - len(r.prefix)],
                     "tokens": r.result(0),
                     "ttft_ms": (r.t_first_token - r.t_submit) * 1e3}
                    for r in pend]
    out["serving_launches"] = dict(S.launches)

    with open(payload_path) as f:
        payload = json.load(f)
    eng2 = engine_of()
    resumed = []
    real_import = eng2.import_requests

    def spy(exported):
        resumed.extend(real_import(exported))
        return resumed

    eng2.import_requests = spy
    S.reset_launches()
    with LMServer(eng2, port=0).start() as srv:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/resume",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        out["resume_ms"] = (time.perf_counter() - t0) * 1e3
        out["resume_reply"] = body
        out["http"] = [{"prompt": r.prompt[:len(r.prompt) - len(r.prefix)],
                        "tokens": r.result(120.0),
                        "ttft_ms": (r.t_first_token - r.t_submit) * 1e3}
                       for r in resumed]
    out["http_serving_launches"] = dict(S.launches)
    out["flash_launches"] = dict(fa.launches)
    with open(result_path, "w") as f:
        json.dump(out, f)
    return 0


def _elastic_serving(cfg, params, out_dir, edir):
    """The serving legs' first incarnation, here: bench.py's trace
    uninterrupted (the rollout every completion is held to); the same
    trace drained by ServingState.drain_commit at a fixed iteration and
    committed; an LMServer drained by POST /drain mid-flight.  Returns
    what the relaunched child needs and the figures."""
    import urllib.error
    import urllib.request

    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.ops import serving as S
    from horovod_tpu_torch.serving import InferenceEngine, harness
    from horovod_tpu_torch.serving.scheduler import FinishReason
    from horovod_tpu_torch.serving.server import LMServer

    def engine_of():
        return InferenceEngine(params, cfg, device="cuda", max_slots=8,
                               page_size=16, capacity=1024)

    trace = harness.serving_trace(40, cfg.vocab_size, seed=7)
    if len({tuple(t["prompt"]) for t in trace}) != len(trace):
        raise AssertionError("the trace's prompts are not distinct")
    eng = engine_of()
    eng.warm_start()
    run = harness.run_trace(eng, trace, True)
    want = {tuple(t["prompt"]): toks for t, toks in zip(trace, run["tokens"])}
    del eng

    # ServingState: drain and commit at a fixed iteration.
    eng = engine_of()
    eng.warm_start()
    S.reset_launches()
    reqs = [eng.submit(t["prompt"], max_new_tokens=t["max_new"],
                       arrival=t["arrival"]) for t in trace]
    state = elastic.ServingState(eng)
    for it in range(ELASTIC_SERVE_DRAIN_AT):
        eng.step(now=it, admit=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exported = state.drain_commit()
    drain_ms = (time.perf_counter() - t0) * 1e3
    blob_bytes = int(state.requests_blob.numel())
    t0 = time.perf_counter()
    if not state.wait_committed(60.0):
        raise AssertionError("the ServingState commit never landed")
    publish_ms = (time.perf_counter() - t0) * 1e3
    done_before = {tuple(r.prompt): r.result(0) for r in reqs
                   if r.finish_reason != FinishReason.DRAINED}
    launches_before = dict(S.launches)
    mid_flight = sum(1 for x in exported if x["generated_prefix"])
    del eng

    # LMServer: POST /drain mid-flight, in-flight handlers answer 503.
    eng = engine_of()
    heavy = sorted(trace, key=lambda t: -t["max_new"])[:ELASTIC_HTTP_REQUESTS]
    replies, drained = {}, {}
    with LMServer(eng, port=0).start() as srv:
        base = f"http://127.0.0.1:{srv.port}"
        orig = eng._decode_iteration
        count = [0]

        def post(path, payload):
            req = urllib.request.Request(
                base + path, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                return json.loads(resp.read())

        def iteration(active):
            count[0] += 1
            if count[0] == ELASTIC_HTTP_DRAIN_AT:
                t0 = time.perf_counter()
                drained.update(post("/drain", {}))
                drained["_ms"] = (time.perf_counter() - t0) * 1e3
            return orig(active)

        eng._decode_iteration = iteration

        def client(t):
            try:
                replies[tuple(t["prompt"])] = ("ok", post(
                    "/generate", {"tokens": t["prompt"],
                                  "max_tokens": t["max_new"]})["tokens"])
            except urllib.error.HTTPError as e:
                replies[tuple(t["prompt"])] = (e.code, json.loads(e.read()))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in heavy]
        for th in threads:
            th.start()
        for th in threads:
            th.join(180.0)
        ready_after = eng.ready
    http_drain_ms = drained.pop("_ms")
    if ready_after or not drained.get("requests"):
        raise AssertionError(f"POST /drain: ready={ready_after}, "
                             f"{len(drained.get('requests', []))} requests")
    if any(code not in ("ok", 503) for code, _ in replies.values()) or \
            not any(code == 503 for code, _ in replies.values()):
        raise AssertionError(f"the /generate replies around the drain: "
                             f"{ {k[:3]: v[0] for k, v in replies.items()} }")
    payload_path = os.path.join(out_dir, "elastic_drain_payload.json")
    with open(payload_path, "w") as f:
        json.dump(drained, f)
    return {"want": want, "done_before": done_before,
            "http_done_before": {k: v[1] for k, v in replies.items()
                                 if v[0] == "ok"},
            "heavy": [tuple(t["prompt"]) for t in heavy],
            "payload_path": payload_path,
            "figures": {"drain_commit_ms": drain_ms,
                        "blob_bytes": blob_bytes,
                        "commit_publish_ms": publish_ms,
                        "exported": len(exported),
                        "exported_mid_flight": mid_flight,
                        "finished_before_drain": len(done_before),
                        "http_drain_ms": http_drain_ms,
                        "http_exported": len(drained["requests"]),
                        "http_503": sum(1 for c, _ in replies.values()
                                        if c == 503)},
            "launches_before": launches_before}


def _elastic_serving_legs(root):
    """(b): the serving legs' first incarnation here, then the relaunched
    incarnation as a child (``--elastic-child serve``).  Returns the
    first's results, the child's and the child's wall seconds."""
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.utils.tree import tree_map

    cfg = transformer_lm.bench_config()
    params = tree_map(lambda x: x.detach(), tt.init_transformer(
        torch.Generator().manual_seed(0), cfg, device="cuda"))
    sv_dir = os.path.join(root, "serving")
    os.makedirs(sv_dir)
    os.environ["HVD_TPU_ELASTIC_DIR"] = sv_dir
    try:
        served = _elastic_serving(cfg, params, root, sv_dir)
    finally:
        os.environ.pop("HVD_TPU_ELASTIC_DIR", None)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    sv_result = os.path.join(root, "serve_child.json")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--elastic-child",
         "serve", "--elastic-result", sv_result, "--elastic-payload",
         served["payload_path"]], cwd=HERE,
        env={**os.environ, "HVD_TPU_ELASTIC_DIR": sv_dir},
        capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"the serving relaunch failed: "
                             f"{child.stderr[-3000:]}")
    with open(sv_result) as f:
        relaunched = json.load(f)
    return served, relaunched, seconds


def phase_elastic(fa, smi_line, out_dir):
    """Elastic training and serving (ROADMAP A.5.3) on the card.  (a) GPT-2-small (bf16, batch 8, seq
    1024, AdamW) through Trainer, TrainerState and @elastic.run as a
    child of ``python -m horovod_tpu_torch.run --elastic -np 1``, 8 steps,
    a commit every 2: uninterrupted; killed hard before step 5 once its
    step-4 commit is durable, relaunched once, resumed from step 4; one
    HorovodError after step 5 retried in process; and killed again under
    HVD_TPU_FAULTS=ckpt.oserror:count=2@7 (the commits land after their
    retries).  Every run's final parameters and AdamW state bitwise the
    uninterrupted run's; each flash kernel 12 times a step in each
    incarnation (bf16 at head_dim 64: the sm90 forms).  (b) bench.py's
    trace served, drained by ServingState.drain_commit at iteration 20,
    committed; a fresh process syncs it on a fresh engine and finishes;
    an LMServer drained mid-flight by POST /drain (503s), the payload
    POSTed to /resume of a fresh server in that process.  Every
    completion bitwise the uninterrupted rollout; the serving kernels
    launch in both incarnations.  (The chaos matrix runs in the control
    phase.)  Prints the commit, relaunch, retry and serving figures.
    Returns the flash and serving launches of the path."""
    import shutil

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    root = os.path.join(out_dir, "elastic")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        return _elastic_paths(fa, smi_line, out_dir, root, t_phase)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _elastic_paths(fa, smi_line, out_dir, root, t_phase):
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.ops import serving as S

    started = []

    def leg(name, args, env=None):
        d = os.path.join(root, name)
        os.makedirs(d)
        result = os.path.join(root, f"{name}.jsonl")
        run = _elastic_launch(args, d, result, env)
        started.append(run[0])
        return run, result

    try:
        return _elastic_legs(fa, smi_line, out_dir, root, t_phase, leg,
                             started, transformer_lm, S)
    finally:
        # A failed leg must not leave a launcher, its workers or the
        # matrix's children running: each is a process group of its own.
        for proc in started:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def _elastic_legs(fa, smi_line, out_dir, root, t_phase, leg, started,
                  transformer_lm, S):
    # Together: (a)'s uninterrupted run, in-process retry and flaky-disk
    # kill start now, and (b) runs here meanwhile; the timed kill and
    # relaunch runs alone after them.
    plain, plain_r = leg("plain", ["train"])
    retry, retry_r = leg("retry", ["retry"])
    flaky, flaky_r = leg("flaky", ["train", "--elastic-die-at",
                                   str(ELASTIC_DIE_AT)],
                         {"HVD_TPU_FAULTS": ELASTIC_FAULTS})
    served, relaunched, t_serve_child = _elastic_serving_legs(root)
    plain_lines, (straight,) = _elastic_finish(plain, plain_r, "plain")
    retry_lines, (retried,) = _elastic_finish(retry, retry_r, "retry")
    flaky_lines, flaky_recs = _elastic_finish(flaky, flaky_r, "flaky")
    killed, killed_r = leg("killed", ["train", "--elastic-die-at",
                                      str(ELASTIC_DIE_AT)])
    killed_lines, killed_recs = _elastic_finish(killed, killed_r, "killed")
    cfg = transformer_lm.bench_config()

    # The training legs: bitwise, launches, resume points, retries.
    def check_killed(lines, recs, what):
        first, second = recs
        relaunch = [t for t, line in lines
                    if line.startswith("[elastic] job failed")]
        if len(relaunch) != 1 or len(recs) != 2:
            raise AssertionError(f"{what}: {len(relaunch)} relaunches, "
                                 f"{len(recs)} incarnations")
        if (first["start_step"], first["steps_run"]) != (0, ELASTIC_DIE_AT) \
                or (second["start_step"], second["steps_run"]) != (
                    4, ELASTIC_STEPS - 4):
            raise AssertionError(f"{what}: incarnations ran "
                                 f"{first['start_step']}+{first['steps_run']}"
                                 f" and {second['start_step']}+"
                                 f"{second['steps_run']} steps")
        for rec in recs:
            want = {k: cfg.n_layers * rec["steps_run"] for k in fa.KERNELS}
            if rec["flash_launches"] != want:
                raise AssertionError(f"{what}: flash launches "
                                     f"{rec['flash_launches']}, want {want}")
        return relaunch[0]

    t_relaunch = check_killed(killed_lines, killed_recs, "killed")
    check_killed(flaky_lines, flaky_recs, "ckpt.oserror")
    for what, rec in (("killed", killed_recs[1]), ("retry", retried),
                      ("ckpt.oserror", flaky_recs[1])):
        if rec["digests"] != straight["digests"] or \
                rec["final_step"] != ELASTIC_STEPS:
            raise AssertionError(f"{what}: the final state is not bitwise "
                                 f"the uninterrupted run's: {rec['digests']} "
                                 f"vs {straight['digests']}")
    if straight["flash_launches"] != {
            k: cfg.n_layers * ELASTIC_STEPS for k in fa.KERNELS}:
        raise AssertionError(f"uninterrupted flash launches "
                             f"{straight['flash_launches']}")
    losses = straight["losses"]
    # Each step draws its own random tokens: the losses need only be
    # finite; the runs are held to each other bit for bit.
    if len(losses) != ELASTIC_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"the elastic leg's losses: {losses}")
    if retried.get("start_step") != 0 or "t_reentered" not in retried:
        raise AssertionError(f"the in-process retry never rolled back: "
                             f"{retried}")
    flaky_text = "\n".join(line for _, line in flaky_lines)
    if flaky_recs[0]["retries"] < 2 or "hvd-chaos: ckpt.oserror" not in \
            flaky_text or "retrying" not in flaky_text:
        raise AssertionError(f"ckpt.oserror: retries "
                             f"{flaky_recs[0]['retries']}")

    # The serving legs: every completion bitwise the uninterrupted one.
    want = served["want"]
    got = dict(served["done_before"])
    for r in relaunched["state"]:
        got[tuple(r["prompt"])] = r["tokens"]
    if got != want:
        bad = [k[:4] for k in want if got.get(k) != want[k]]
        raise AssertionError(f"ServingState: {len(bad)} completions differ "
                             f"from the uninterrupted rollout: {bad[:5]}")
    http_got = {k: v for k, v in served["http_done_before"].items()}
    for r in relaunched["http"]:
        http_got[tuple(r["prompt"])] = r["tokens"]
    if http_got != {k: want[k] for k in served["heavy"]}:
        raise AssertionError("the /drain and /resume completions differ "
                             "from the uninterrupted rollout")
    for name in S.KERNELS:
        if not served["launches_before"].get(name) or \
                not relaunched["serving_launches"].get(name) or \
                not relaunched["http_serving_launches"].get(name):
            raise AssertionError(
                f"{name} did not launch in both incarnations: "
                f"{served['launches_before']} "
                f"{relaunched['serving_launches']} "
                f"{relaunched['http_serving_launches']}")
    if any(relaunched["flash_launches"].values()):
        raise AssertionError("the serving relaunch launched flash kernels")

    # Figures.
    first, second = killed_recs
    commit_ms = first["commit_ms"] + second.get("commit_ms", [])
    ws = second["write_seconds"]
    figures = {
        "commit_host_snapshot_ms": commit_ms,
        "commit_snapshot_bytes": straight["snapshot_bytes"],
        "commit_file_bytes": straight["file_bytes"],
        "commit_publish_s_mean": ws["sum"] / ws["count"],
        "commit_publish_MB_per_s": straight["file_bytes"]
        / (ws["sum"] / ws["count"]) / 1e6,
        "wait_committed_before_death_s": first["wait_committed_s"],
        "death_to_relaunch_s": t_relaunch - first["t_death"],
        "relaunch_to_process_start_s": second["t_process_start"]
        - t_relaunch,
        "relaunch_to_init_done_s": second["t_init_done"] - t_relaunch,
        "restore_and_sync_ms": second["sync_ms"],
        "first_resumed_step_ms": second["step_ms"][0],
        "relaunch_to_first_resumed_step_s": second["t_entered"]
        - t_relaunch + second["step_ms"][0] / 1e3,
        "step_ms_uninterrupted": straight["step_ms"],
        "retry_rollback_ms": (retried["t_rolled_back"]
                              - retried["t_raised"]) * 1e3,
        "retry_sync_ms": (retried["t_reentered"]
                          - retried["t_rolled_back"]) * 1e3,
        "ckpt_oserror_retries": flaky_recs[0]["retries"],
        **served["figures"],
        "serving_relaunch_sync_ms": relaunched["sync_ms"],
        "resumed_ttft_ms_p50": _pct([r["ttft_ms"]
                                     for r in relaunched["state"]], 0.5),
        "resumed_ttft_ms_max": max(r["ttft_ms"]
                                   for r in relaunched["state"]),
        "http_resume_ms": relaunched["resume_ms"],
        "http_resumed_ttft_ms_p50": _pct([r["ttft_ms"]
                                          for r in relaunched["http"]], 0.5),
        "serving_relaunch_s": t_serve_child}
    log(smi_line)
    log({"phase": "elastic", "device": smi_line, **figures,
         "bitwise": {"killed": True, "retry": True, "ckpt_oserror": True,
                     "serving_state": True, "http": True},
         "losses": losses,
         "flash_launches_per_step": {
             k: [rec["flash_launches"][k] / rec["steps_run"]
                 for rec in killed_recs] for k in fa.KERNELS},
         "serving_launches": {"first": served["launches_before"],
                              "relaunched": relaunched["serving_launches"],
                              "http_relaunched":
                                  relaunched["http_serving_launches"]},
         "seconds": time.perf_counter() - t_phase})
    return {"flash": {k: killed_recs[0]["flash_launches"][k]
                      + killed_recs[1]["flash_launches"][k]
                      for k in fa.KERNELS},
            "serving": {k: served["launches_before"][k]
                        + relaunched["serving_launches"][k]
                        + relaunched["http_serving_launches"][k]
                        for k in S.KERNELS}}


# -- control: the TCP control channel (ROADMAP A.5 item 4 with A.2 item 8)

CONTROL_STEPS = 6        # GPT-2-small AdamW steps a run (legs b and c)
CONTROL_SEQ = 128        # tokens a rank a step (batch 1 a rank)
CONTROL_SEED = 41        # the reset specs' seed
CONTROL_RESET_AFTER = 2  # the reset lands after this many steps


CONTROL_LAYERS = 2       # the depth the control legs cut GPT-2-small to


def control_config():
    """GPT-2-small at full width (vocab 32768, d 768, 12 heads, d_ff
    3072) in f32, cut to CONTROL_LAYERS layers: the control legs train it
    on CPU ranks."""
    from horovod_tpu_torch.examples import transformer_lm

    return dataclasses.replace(transformer_lm.bench_config(CONTROL_SEQ),
                               dtype=torch.float32, n_layers=CONTROL_LAYERS)


def _sum_counts(counts):
    total = {}
    for c in counts:
        for k, n in c.items():
            total[k] = total.get(k, 0) + n
    return total


def control_child(result_path) -> int:
    """One rank of the control phase's GPT-2-small runs (``python -m
    horovod_tpu_torch.run -np N chip_smoke.py --control-child PATH``): on
    the CPU, one thread, seed-0 weights broadcast from rank 0, batch 1 of
    CONTROL_SEQ tokens a rank (seeded by the rank), the hook-driven
    ``DistributedOptimizer`` over AdamW, CONTROL_STEPS steps.  Writes
    PATH.rank<r>.json: losses, the frames sent and reconnects after each
    step, the kernel launches of the steps (counters zeroed just before
    them), sha256 of the parameters and of AdamW's state, the channel's
    class and, on rank 0, the frames it gathered a cycle and, under the
    tree, its steady-state envelopes (``[ranks, h, trailer bytes, hit
    sections, payload bytes, envelopes]``)."""
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.chaos import matrix as _matrix
    from horovod_tpu_torch.core import state as st
    from horovod_tpu_torch.frontends import torch as hvd_torch
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.utils.tree import tree_leaves, tree_named_leaves

    cfg = control_config()
    hvd.init(device="cpu")
    rank = hvd.rank()
    channel = st._state.channel
    steady = None
    if rank == 0 and getattr(channel, "tree", None) is not None:
        steady = _matrix.tally_steady_envelopes(channel)
    params = tt.init_transformer(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    hvd.broadcast_parameters(params, root_rank=0)
    adamw = torch.optim.AdamW(tree_leaves(params), lr=3e-4,
                              weight_decay=1e-4)
    opt = hvd_torch.DistributedOptimizer(
        adamw, named_parameters=tree_named_leaves(params))
    step = hvd.make_train_step(tt.make_loss_fn(cfg), opt)
    data = tt.synthetic_lm_batch(torch.Generator().manual_seed(1 + rank), 1,
                                 CONTROL_SEQ, cfg.vocab_size)

    def metric(name):
        return telemetry.metrics().get(name, {}).get("value", 0)

    rec = {"rank": rank, "size": hvd.size(), "losses": [],
           "frames_sent": [], "reconnects": [], "step_s": []}
    _matrix.reset_launches()
    for _ in range(CONTROL_STEPS):
        t0 = time.perf_counter()
        rec["losses"].append(float(step(params, data)))
        rec["step_s"].append(time.perf_counter() - t0)
        rec["frames_sent"].append(metric("transport.frames_sent"))
        rec["reconnects"].append(metric("transport.reconnects"))
    rec["launches"] = _matrix.launch_counts()
    state = adamw.state_dict()["state"]
    rec["params"] = _digest_tensors(tree_leaves(params))
    rec["adamw"] = _digest_tensors([v[k] for _, v in sorted(state.items())
                                    for k in sorted(v)
                                    if isinstance(v[k], torch.Tensor)])
    rec["channel"] = type(channel).__name__
    if rank == 0:
        rec["frame_counts"] = {str(k): v
                               for k, v in channel.frame_counts.items()}
        rec["steady_envelopes"] = sorted(
            [*key, n] for key, n in (steady or {}).items())
    hvd.shutdown()
    with open(f"{result_path}.rank{rank}.json", "w") as f:
        json.dump(rec, f)
    return 0


def _control_launch(np_, result, env):
    """Start ``np_`` control children under the launcher."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
           os.path.abspath(__file__), "--control-child", result]
    full = {k: v for k, v in os.environ.items() if k != "HVD_TPU_FAULTS"}
    full.update(OMP_NUM_THREADS="1", **env)
    return subprocess.Popen(cmd, cwd=HERE, env=full, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _control_finish(proc, result, np_, what, timeout=900):
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"control {what}: the launcher exited "
                             f"{proc.returncode}\n{out[-4000:]}")
    recs = []
    for r in range(np_):
        with open(f"{result}.rank{r}.json") as f:
            recs.append(json.load(f))
    return out, recs


def _reset_after(recs, rank):
    """The frames ``rank`` had sent by the end of step CONTROL_RESET_AFTER
    + 1 of the fault-free run ``recs``: a reset after that many lands
    after step CONTROL_RESET_AFTER of a run that sends up to 1.5 times as
    many frames a step (a rank sends one frame a cycle, and the idle
    cycles of the background thread make the count follow the time), and
    before the last step of one that sends half as many."""
    return recs[rank]["frames_sent"][CONTROL_RESET_AFTER]


def phase_control(smi_line, out_dir):
    """The TCP control channel (ROADMAP A.5 item 4 with A.2 item 8): its
    multi-rank legs run as CPU ranks on the card's machine (one card is
    one NCCL rank, and one rank has no exchange).  (a) python -m
    horovod_tpu_torch.chaos --matrix: the local scenarios on the card,
    every cp fleet (the ten TCP scenarios with them) on the CPU.  (b)
    GPT-2-small (control_config) through the hook-driven
    DistributedOptimizer under python -m horovod_tpu_torch.run -np 2,
    CONTROL_STEPS AdamW steps, with no fault and under a transport.reset
    of rank 1 after step CONTROL_RESET_AFTER: bitwise, one resume.  (c)
    the same at -np 3, flat, under HVD_TPU_TREE=on HVD_TPU_TREE_FANOUT=1,
    and the tree under a reset of the leaf (rank 2): bitwise the flat
    run, rank 0 gathering expected_root_frames(3, 1) frames a cycle, each
    steady-state envelope the interior merged one hit section of 11 + 4n
    + 4h + n*c bytes (ops/tree.py).  (d)
    tools/control_ab.py on this tree, beside the faulted runs: the 4 B
    negotiated allreduce's median at np 2 and 3, a hard kill to its
    diagnosis, a reset to its resume.  Returns the phase's figures."""
    import shutil

    t_phase = time.perf_counter()
    root = os.path.join(out_dir, "control")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    started = []
    try:
        return _control_legs(smi_line, out_dir, root, t_phase, started)
    finally:
        for proc in started:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def _control_legs(smi_line, out_dir, root, t_phase, started):
    from horovod_tpu_torch.ops import tree as _tree

    # (a) The whole chaos matrix.
    matrix_out = os.path.join(out_dir, "chaos_matrix.txt")
    t0 = time.perf_counter()
    with open(matrix_out, "w") as f:
        mx = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.chaos", "--matrix",
             "--device", "cuda", "--jobs", "8"], cwd=HERE, stdout=f,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    started.append(mx)
    mx.wait(timeout=600)
    matrix_s = time.perf_counter() - t0
    with open(matrix_out) as f:
        text = f.read()
    report = json.loads(text[text.index("\n{") + 1:])
    if mx.returncode != 0 or report["failed"]:
        raise AssertionError(f"the chaos matrix: rc {mx.returncode}, "
                             f"{report['failed']} failed\n{text[-3000:]}")
    from horovod_tpu_torch.chaos import matrix as _matrix

    unreported = {r["scenario"]: r["unreported"]
                  for r in report["scenarios"] if r["unreported"]}
    if unreported:
        raise AssertionError(f"the matrix: processes that printed no "
                             f"launch counts: {unreported}")
    kinds = {s.name: s.kind for s in _matrix.SCENARIOS}
    by_name = {r["scenario"]: r for r in report["scenarios"]}
    # The router's scenarios: each passed (its needle shown, its digests
    # the fault-free pass's) with its one fault fired.
    for name in ("router_replica_death", "router_restart"):
        r = by_name.get(name, {})
        if r.get("status") != "PASS" or r.get("fired") != 1:
            raise AssertionError(f"the matrix's {name}: {r}")
    devices = {r["scenario"]: r["device"] for r in report["scenarios"]}
    if set(devices) != set(kinds) or any(
            devices[n] != ("cpu" if kinds[n] == "cp" else "cuda")
            for n in devices):
        raise AssertionError(f"the matrix's devices: {devices}")

    # (b) and (c): the fault-free runs together, then the faulted ones,
    # each reset placed by the fault-free run's frame counts
    # (_reset_after) and checked to land after step CONTROL_RESET_AFTER.
    def launch(name, np_, env):
        result = os.path.join(root, name)
        proc = _control_launch(np_, result, env)
        started.append(proc)
        return proc, result, np_, name

    flat3 = {"HOROVOD_FUSION_THRESHOLD": "0", "HVD_TPU_TREE": "off"}
    tree3 = {"HOROVOD_FUSION_THRESHOLD": "0", "HVD_TPU_TREE": "on",
             "HVD_TPU_TREE_FANOUT": "1"}
    t0 = time.perf_counter()
    first = [launch("np2", 2, {}), launch("flat3", 3, flat3),
             launch("tree3", 3, tree3)]
    (_, np2), (_, f3), (_, t3) = [_control_finish(*run) for run in first]
    clean_s = time.perf_counter() - t0
    n2, n3 = _reset_after(np2, 1), _reset_after(t3, 2)
    spec2 = f"transport.reset:count=1:after={n2}:rank=1@{CONTROL_SEED}"
    spec3 = f"transport.reset:count=1:after={n3}:rank=2@{CONTROL_SEED}"
    t0 = time.perf_counter()
    second = [launch("np2_reset", 2, {"HVD_TPU_FAULTS": spec2}),
              launch("tree3_reset", 3, {**tree3, "HVD_TPU_FAULTS": spec3})]
    # (d) Host timings of this tree (tools/control_ab.py, one round) on
    # the cores the faulted runs leave; the A/B against another checkout
    # in turns is that tool's --trees A,B on a quiet machine.
    ab = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "tools", "control_ab.py"),
         "--trees", HERE, "--rounds", "1"], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    started.append(ab)
    (out2, np2r), (out3, t3r) = [_control_finish(*run) for run in second]
    faulted_s = time.perf_counter() - t0
    ab_out, ab_err = ab.communicate(timeout=600)
    ab_s = time.perf_counter() - t0
    if ab.returncode != 0:
        raise AssertionError(f"control_ab: rc {ab.returncode}\n"
                             f"{ab_out[-2000:]}{ab_err[-3000:]}")
    ab_last = json.loads(ab_out.strip().splitlines()[-1])
    timings = ab_last["medians"][HERE]

    def same(a, b, what):
        for ra, rb in zip(a, b):
            if (ra["params"], ra["adamw"]) != (rb["params"], rb["adamw"]):
                raise AssertionError(
                    f"control {what}: rank {ra['rank']}'s parameters or "
                    f"AdamW state are not bitwise: {ra['params'][:12]}/"
                    f"{ra['adamw'][:12]} vs {rb['params'][:12]}/"
                    f"{rb['adamw'][:12]}")

    def resumed_once(recs, out, rank, what):
        rc = recs[rank]["reconnects"]
        if "session resumed" not in out or rc[-1] != 1 \
                or rc[CONTROL_RESET_AFTER - 1] != 0:
            raise AssertionError(
                f"control {what}: rank {rank}'s transport.reconnects a "
                f"step {rc} (one reconnect after step "
                f"{CONTROL_RESET_AFTER} wanted)\n{out[-3000:]}")

    same(np2, np2r, "np 2 under transport.reset")
    resumed_once(np2r, out2, 1, "np 2")
    same(f3, t3, "np 3 tree against flat")
    same(f3, t3r, "np 3 tree under transport.reset against flat")
    resumed_once(t3r, out3, 2, "np 3 tree")
    for recs in (np2, np2r, f3, t3, t3r):
        for rec in recs:
            if not all(np.isfinite(rec["losses"])):
                raise AssertionError(f"control: losses {rec['losses']}")
    if np2[0]["losses"][0] <= np2[0]["losses"][-1]:
        raise AssertionError(f"control: the loss did not fall: "
                             f"{np2[0]['losses']}")
    want_root = _tree.expected_root_frames(3, 1)
    root_frames = {}
    for name, recs in (("flat3", f3), ("tree3", t3), ("tree3_reset", t3r)):
        fc = recs[0]["frame_counts"]
        root_frames[name] = {"most_common": int(max(fc, key=fc.get)),
                             "cycles_by_frames": fc}
    if root_frames["tree3"]["most_common"] != want_root or \
            root_frames["tree3_reset"]["most_common"] != want_root or \
            root_frames["flat3"]["most_common"] != 2:
        raise AssertionError(f"control: rank 0's frames a cycle "
                             f"{root_frames}, want {want_root} under the "
                             f"tree and 2 flat")
    if [r["channel"] for r in t3] != ["ControllerTransport",
                                      "TreeWorkerTransport",
                                      "TreeWorkerTransport"]:
        raise AssertionError(f"control: the tree run's channels "
                             f"{[r['channel'] for r in t3]}")
    # The interior's merge: every steady-state envelope rank 0 took (each
    # rank of the subtree sent the same h hits and at most a trace
    # context) from both ranks is one hit section of 11 + 4n + 4h + n*c
    # bytes, n = 2, c the steady batch section (tree.STEADY_BATCH_BYTES)
    # plus the trailer.  In tree3 every one is; in tree3_reset some are
    # (those before the reset: after it the leaf is rank 0's own child),
    # and after the reset the interior's envelope holds itself alone,
    # its record in its batch section, 2 + 22 + 9 + 4h + trailer bytes.
    steady = {name: recs[0]["steady_envelopes"]
              for name, recs in (("flat3", f3), ("tree3", t3),
                                 ("tree3_reset", t3r))}
    for name in ("tree3", "tree3_reset"):
        for n_, h, trailer, groups, nbytes, _count in steady[name]:
            if n_ == 2:
                want = (1, 11 + 4 * n_ + 4 * h
                        + n_ * (_tree.STEADY_BATCH_BYTES + trailer))
            elif n_ == 1 and name == "tree3_reset":
                want = (0, 2 + 22 + 9 + 4 * h + trailer)
            else:
                want = None
            if trailer not in (0, 25) or (groups, nbytes) != want:
                raise AssertionError(
                    f"control {name}: a steady envelope of {n_} ranks, "
                    f"{h} hits, {groups} hit sections and {nbytes} B "
                    f"(want {want}: hit sections, bytes)")
        if not any(row[0] == 2 for row in steady[name]):
            raise AssertionError(f"control {name}: rank 0 took no "
                                 f"steady-state envelope of both ranks")
    if steady["flat3"]:
        raise AssertionError(f"control: the flat run's envelopes "
                             f"{steady['flat3']}")

    # The phase's kernel launches, each process's counters zeroed just
    # before its work: the matrix's local scenarios run on the card (the
    # serving ones launch serving_gemm and cache_attention), its cp
    # fleets, the GPT-2-small ranks and control_ab's ranks on the CPU.
    launches = {
        "matrix": _sum_counts(r["launches"] for r in report["scenarios"]),
        "matrix_by_scenario": {
            r["scenario"]: {k: n for k, n in r["launches"].items() if n}
            for r in report["scenarios"]},
        "gpt2_ranks": _sum_counts(rec["launches"] for recs in (
            np2, np2r, f3, t3, t3r) for rec in recs),
        "control_ab": ab_last["launches"][HERE]}
    launches["total"] = _sum_counts(
        [launches["matrix"], launches["gpt2_ranks"], launches["control_ab"]])
    figures = {
        "matrix": [{k: r.get(k) for k in ("scenario", "status", "device",
                                          "seconds", "fired", "note")}
                   for r in report["scenarios"]],
        "launches": launches,
        "matrix_seconds": matrix_s,
        "reset_after_frames": {"np2_rank1": n2, "tree3_rank2": n3},
        "reconnects": {"np2_rank1": np2r[1]["reconnects"],
                       "tree3_rank2": t3r[2]["reconnects"]},
        "losses_np2": np2[0]["losses"], "losses_np3": f3[0]["losses"],
        "step_s_np2": np2[0]["step_s"], "step_s_np3_flat": f3[0]["step_s"],
        "step_s_np3_tree": t3[0]["step_s"],
        "root_frames_a_cycle": root_frames,
        "expected_root_frames_3_1": want_root,
        "steady_envelopes": steady,
        "latency_np2_ms": timings["latency_np2_ms"],
        "latency_np3_ms": timings["latency_np3_ms"],
        "kill_to_diagnosis_s": timings["kill_to_diagnosis_s"],
        "reset_to_resumed_s": timings["reset_to_resumed_s"],
        "clean_runs_s": clean_s, "faulted_runs_s": faulted_s,
        "control_ab_s": ab_s}
    log(smi_line)
    log({"phase": "control", "device": smi_line, **figures,
         "bitwise": {"np2_reset": True, "np3_tree": True,
                     "np3_tree_reset": True},
         "seconds": time.perf_counter() - t_phase})
    return figures


# -- tuning: closed-loop tuning (ROADMAP A.5 item 5) -------------------------

TUNING_ENV = ("HOROVOD_AUTOTUNE", "HOROVOD_AUTOTUNE_LOG",
              "HOROVOD_AUTOTUNE_WARMUP_SAMPLES",
              "HOROVOD_AUTOTUNE_SAMPLE_SECONDS", "HVD_TPU_TUNE",
              "HVD_TPU_TUNE_WINDOW", "HVD_TPU_TUNE_PIN",
              "HVD_TPU_DCN_COMPRESS", "HVD_TPU_MAX_INFLIGHT",
              "HVD_TPU_SPEC_TOKENS", "HVD_TPU_PREFIX_PAGES")
TUNING_SAMPLE_SECONDS = 0.5  # the sweep's sample window (leg a)
TUNING_WINDOW = 8            # cycles a decision window (leg b)
TUNING_TIMED_STEPS = 10      # timed hook steps a turn (2 warm-up before)
TUNING_REQUESTS = 48         # the served trace's requests (leg b)
TUNING_HEADER = 64           # the tokens every prompt shares (leg b)


def _tuning_env(values):
    """Set the tuning knobs to ``values`` (the others unset)."""
    for k in TUNING_ENV:
        os.environ.pop(k, None)
    os.environ.update(values)


def _stream_log(rt, tuner):
    """Record rank 0's cycles and the RETUNE markers it applies: each
    marker's seq, tokens, the cycle and time of its enqueue and apply."""
    from horovod_tpu_torch.ops.wire import ResponseType

    log = {"cycles": 0, "enqueued": {}, "applied": []}
    negotiate, execute, enqueue = rt._negotiate, rt._execute, tuner._enqueue

    def negotiating(batches):
        log["cycles"] += 1
        return negotiate(batches)

    def executing(resp, tl=None):
        if resp.response_type == ResponseType.RETUNE:
            seq = int(resp.tensor_sizes[0])
            c0, t0 = log["enqueued"].get(seq, (None, None))
            log["applied"].append({
                "seq": seq, "tokens": list(resp.tensor_names),
                "cycles_to_apply": None if c0 is None
                else log["cycles"] - c0,
                "ms_to_apply": None if t0 is None
                else (time.perf_counter() - t0) * 1e3})
        return execute(resp, tl)

    def enqueuing(tokens, undo=None):
        seq = enqueue(tokens, undo)
        log["enqueued"][seq] = (log["cycles"], time.perf_counter())
        return seq

    rt._negotiate, rt._execute, tuner._enqueue = negotiating, executing, \
        enqueuing
    return log


def _tuning_counters():
    from horovod_tpu_torch import telemetry

    m = telemetry.metrics()
    return {k: m.get(f"tuning.{k}", {}).get("value", 0)
            for k in ("applied", "decisions", "vetoes", "rollbacks")}


def _tuning_sweep(fa, out_dir, res):
    """Leg (a): GPT-2-small's hook step under HOROVOD_AUTOTUNE=1 and
    HVD_TPU_TUNE=1 until the sweep's commit is applied; then the hook
    step with the controller on and off in turns, and one profiled
    step.  Returns the run's losses and digests."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import trace
    from horovod_tpu_torch.core import state as st_mod
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.ops import quant, serving as S
    from horovod_tpu_torch.tuning import Tuner
    from horovod_tpu_torch.utils import autotune
    from horovod_tpu_torch.utils.tree import tree_leaves

    csv = os.path.join(out_dir, "autotune.csv")
    _tuning_env({"HOROVOD_AUTOTUNE": "1", "HVD_TPU_TUNE": "1",
                 "HOROVOD_AUTOTUNE_LOG": csv,
                 "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
                 "HOROVOD_AUTOTUNE_SAMPLE_SECONDS": str(TUNING_SAMPLE_SECONDS)})
    cfg = transformer_lm.bench_config()
    run = transformer_lm.train(cfg, batch=8, seq=1024, steps=0,
                               device="cuda", seed=0, hooks=True)
    try:
        st = st_mod._state
        tuner = st.autotuner
        if tuner is None or tuner is not st.tuner or tuner.policy is None:
            raise AssertionError("init did not install the closed loop with "
                                 "the sweep folded in")
        log = _stream_log(st.runtime, tuner)
        for mod in (fa, quant, S):
            mod.reset_launches()
        losses, per_step = [], []
        t0 = time.perf_counter()
        while not tuner.done:
            if len(losses) >= 1000:
                raise AssertionError(f"the sweep did not commit in 1000 "
                                     f"steps: {log['applied'][-3:]}")
            before = dict(fa.launches)
            losses.append(float(run["step"](run["params"], run["data"])))
            per_step.append({k: n - before[k] for k, n in fa.launches.items()})
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        flash = dict(fa.launches)
        other = {**{k: quant.launches[k] for k in quant.KERNELS},
                 **{k: S.launches[k] for k in S.KERNELS}}
        if any(c != {k: cfg.n_layers for k in fa.KERNELS} for c in per_step):
            raise AssertionError(f"each flash kernel must launch "
                                 f"{cfg.n_layers} times a step: {per_step}")
        grid = [(t, c) for t in autotune.DEFAULT_THRESHOLDS
                for c in autotune.DEFAULT_CYCLES]
        th, cy = tuner.committed
        sent = [(m["seq"], m["tokens"]) for m in log["applied"]]
        want = [[f"fusion_threshold={t}", f"cycle_time={float(c)}"]
                for t, c in grid + [(th, cy)]]
        # The rule table's markers may ride between them (never on the
        # sweep's knobs, checked below); seqs rise in stream order.
        if [t for _, t in sent if t[0].startswith("fusion_threshold=")] \
                != want or [q for q, _ in sent] != sorted(
                    q for q, _ in sent):
            raise AssertionError(f"the sweep's markers, in stream order: "
                                 f"{sent}")
        coords = [c.fusion_threshold for c in st.runtime._coordinators()]
        if (st.fusion_threshold_bytes, st.tick_seconds) != (th, cy) or \
                coords != [th]:
            raise AssertionError(f"committed {(th, cy)}, the runtime holds "
                                 f"{(st.fusion_threshold_bytes, st.tick_seconds)}"
                                 f", the coordinators {coords}")
        with open(csv) as f:
            rows = f.read().splitlines()
        if len(rows) != 17 or rows[-1] != f"# committed,{th},{cy}":
            raise AssertionError(f"the autotune log: {rows}")
        decided = [(d.knob, d.value, d.reason)
                   for d in tuner.policy.decisions]
        if any(k in ("fusion_threshold", "cycle_time") for k, _, _ in decided):
            raise AssertionError(f"the rule table touched a sweep knob: "
                                 f"{decided}")
        leaves = tree_leaves(run["params"])
        digest = _digest_tensors(leaves)
        res["sweep"] = {
            "steps": len(losses), "seconds": sweep_s,
            "scores": [dict(zip(("bytes_per_s", "fusion_threshold",
                                 "cycle_time_s"), map(float, r.split(","))))
                       for r in rows[1:16]],
            "committed": [th, cy], "markers": log["applied"],
            "rule_decisions": decided, "flash_launches": flash,
            "other_launches": other, "loss_first_last": [losses[0],
                                                         losses[-1]]}
        # The controller's own cost on the host: the hook step with
        # HVD_TPU_TUNE=1's controller and without it, in turns.
        closed = Tuner(st, closed_loop=True)
        turns = []
        for on in (True, False, False, True) * 2:
            st.tuner = st.autotuner = closed if on else None
            for _ in range(2):
                run["step"](run["params"], run["data"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TUNING_TIMED_STEPS):
                run["step"](run["params"], run["data"])
            torch.cuda.synchronize()
            turns.append({"tune": on, "step_ms": (time.perf_counter() - t0)
                          * 1e3 / TUNING_TIMED_STEPS})
        res["hook_step_turns"] = turns
        # One window's sensor pass on the span buffer as it stands.
        t0 = time.perf_counter()
        closed._sensors.sample()
        res["sensor_pass_ms"] = (time.perf_counter() - t0) * 1e3
        res["span_buffer_events"] = len(trace.export_events())
        prof = profile_step(lambda: run["step"](run["params"], run["data"]),
                            out_dir, "tuning")
        # The form from the profile (which may drop records in a long
        # run); the counts a step from the launch counters, above.
        names = " ".join(prof["flash_kernels"])
        for want_k in ("flash_fwd_sm90_kernel", "flash_bwd_dkdv_sm90_kernel",
                       "flash_bwd_dq_sm90_kernel"):
            ran = sum(n for name, n in prof["flash_kernels"].items()
                      if want_k in name)
            if not 1 <= ran <= cfg.n_layers:
                raise AssertionError(f"the profiled tuned step ran {want_k} "
                                     f"{ran} times: {names}")
        for first_form in ("flash_fwd_kernel<", "flash_bwd_dkdv_kernel<",
                           "flash_bwd_dq_kernel<"):
            if first_form in names:
                raise AssertionError(f"the tuned step ran {first_form}")
        res["profiled_step"] = {k: prof[k] for k in (
            "profiled_step_ms", "device_busy_ms", "device_idle_share",
            "flash_kernels")}
        res["counters_a"] = _tuning_counters()
        del run, leaves
    finally:
        hvd.shutdown()
        _tuning_env({})
    return losses, digest, flash, other


def _tuning_untuned(n_steps):
    """Leg (a)'s reference: the same steps with the tuning env unset."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.utils.tree import tree_leaves

    try:
        run = transformer_lm.train(transformer_lm.bench_config(), batch=8,
                                   seq=1024, steps=n_steps, device="cuda",
                                   seed=0, hooks=True)
        return run["losses"], _digest_tensors(tree_leaves(run["params"]))
    finally:
        hvd.shutdown()


def _tuning_trace(vocab):
    """Leg (b)'s trace: TUNING_REQUESTS prompts of 900-1000 tokens that
    share a TUNING_HEADER-token header, each asking for 2-16 new tokens
    (seeded): eight such sequences hold more than 75% of the KV pages,
    the shared header counted once."""
    g = np.random.default_rng(23)
    header = g.integers(0, vocab, TUNING_HEADER).tolist()
    reqs = []
    for _ in range(TUNING_REQUESTS):
        n = int(g.integers(900, 1001))
        prompt = header + g.integers(0, vocab, n - TUNING_HEADER).tolist()
        reqs.append((prompt, int(min(16, 1024 - n, g.integers(2, 17)))))
    return reqs


def _tuning_serve(params, cfg, draft, dcfg, trace_reqs, tuned):
    """Serve the trace once; after each engine iteration one negotiated 4
    B allreduce (a process serves without negotiated collectives, and the
    controller ticks on the cycle).  Returns the tokens and, tuned, the
    decisions, markers, depths and launches."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import state as st_mod
    from horovod_tpu_torch.ops import flash_attention as fa, quant
    from horovod_tpu_torch.ops import serving as S
    from horovod_tpu_torch.serving import InferenceEngine

    _tuning_env({"HVD_TPU_TUNE": "1", "HVD_TPU_TUNE_WINDOW":
                 str(TUNING_WINDOW), "HVD_TPU_TUNE_PIN":
                 "dcn_compress,max_inflight,fusion_threshold,cycle_time"}
                if tuned else {})
    gc.collect()  # earlier phases' engines leave the actuation's sets
    hvd.init(device="cuda")
    try:
        st = st_mod._state
        eng = InferenceEngine(params, cfg, device="cuda", max_slots=8,
                              page_size=16, capacity=1024,
                              draft=(draft, dcfg), spec_tokens=3,
                              prefix_pages=0)
        eng.warm_start()
        log = _stream_log(st.runtime, st.tuner) if tuned else None
        depths = []
        dispatch = eng._spec_dispatch
        used = [None]

        def spec_dispatch(slots):
            used[0] = eng.spec_tokens
            return dispatch(slots)

        eng._spec_dispatch = spec_dispatch
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in trace_reqs]
        tick = torch.zeros(1, device="cuda")
        for mod in (fa, quant, S):
            mod.reset_launches()
        t0 = time.perf_counter()
        while not eng.scheduler.idle():
            used[0] = None
            eng.step()
            depths.append((eng.spec_tokens, used[0],
                           eng.cache.free_pages()))
            hvd.allreduce(tick, op=hvd.Sum, name="tuning.tick")
        # A decision of the last cycles still reaches the stream.
        for _ in range(4 * TUNING_WINDOW):
            if not tuned or len(log["applied"]) >= len(
                    st.tuner.policy.decisions):
                break
            hvd.allreduce(tick, op=hvd.Sum, name="tuning.tick")
        torch.cuda.synchronize()
        out = {"tokens": [r.result(0) for r in reqs],
               "seconds": time.perf_counter() - t0,
               "iterations": len(depths),
               "acceptance": eng.spec_acceptance_rate,
               "serving": dict(S.launches),
               "by_form": {f"{k}/{f}": n for (k, f), n in
                           S.launches_by_form.items()},
               "other": {**dict(fa.launches), **dict(quant.launches)}}
        if tuned:
            tuner = st.tuner
            out.update(
                decisions=[(d.seq, d.window, d.knob, d.value, d.reason)
                           for d in tuner.policy.decisions],
                markers=log["applied"], cycles=log["cycles"],
                depths=depths, counters=_tuning_counters(),
                final={"spec_tokens": eng.spec_tokens,
                       "prefix_target": eng.cache._prefix_target,
                       "prefix": eng.cache.prefix_stats()})
        del eng
        return out
    finally:
        hvd.shutdown()
        _tuning_env({})


def phase_tuning(fa, smi_line, out_dir):
    """Closed-loop tuning (ROADMAP A.5 item 5).  (a) GPT-2-small (bf16,
    batch 8, seq 1024) through the hook-driven DistributedOptimizer on one
    rank under HOROVOD_AUTOTUNE=1 and HVD_TPU_TUNE=1 (the sweep folded into
    the controller; a TUNING_SAMPLE_SECONDS sample window, one warm-up
    sample, the log in the out dir) until ``autotuner.done``: the 15
    (threshold, cycle) candidates and the commit applied as RETUNE markers
    in stream order, the committed pair in the runtime and the
    coordinators, the 15 CSV rows and the commit line, the rule table off
    the pinned knobs, every step's losses and the final weights bitwise an
    untuned run of as many steps (on one rank a threshold only regroups
    responses), each flash kernel 12 times a step and, in a profiled step,
    in the sm90 form; then the hook step with the controller on and off,
    in turns (the controller's own host cost; no gain is claimed).  (b)
    GPT-2-small served (8 slots, page 16, capacity 1024) with an untrained
    draft at distill_draft's shape (d 384, 6 layers; acceptance below 0.5)
    on a trace whose 900-1000-token prompts share a header (the index hot
    while free KV falls under 25%), under HVD_TPU_TUNE=1 with a window of
    TUNING_WINDOW cycles and the knobs under no test pinned.  A process
    serves without negotiated collectives and the controller ticks on
    rank 0's cycle, so the leg posts one 4 B negotiated allreduce after
    each engine iteration (as tests/test_tuning.py's
    ``_drive_until_applied`` drives the reference).  The live sensors'
    policy must decide a spec_tokens shrink and a prefix_pages grow, each
    applied through a marker; the engine's depth changes only between
    iterations; every request's tokens bitwise the trace served with
    HVD_TPU_TUNE unset; serving_gemm and cache_attention in their Hopper
    forms.  Returns the launches."""
    from horovod_tpu_torch.examples import distill_draft, transformer_lm
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.utils.tree import tree_map

    t_phase = time.perf_counter()
    saved = {k: os.environ[k] for k in TUNING_ENV if k in os.environ}
    res = {}
    try:
        losses, digest, flash, other_a = _tuning_sweep(fa, out_dir, res)
        plain_losses, plain_digest = _tuning_untuned(len(losses))
        if plain_losses != losses or plain_digest != digest:
            raise AssertionError(
                f"the tuned hook run is not bitwise the untuned one: losses "
                f"{losses[:3]}... vs {plain_losses[:3]}..., weights "
                f"{digest[:12]} vs {plain_digest[:12]}")
        res["sweep"]["bitwise_untuned"] = True
        t_a = time.perf_counter() - t_phase

        cfg = transformer_lm.bench_config()
        dcfg = distill_draft.draft_config(cfg)
        params = tree_map(lambda x: x.detach(), tt.init_transformer(
            torch.Generator().manual_seed(0), cfg, device="cuda"))
        draft = tree_map(lambda x: x.detach(), tt.init_transformer(
            torch.Generator().manual_seed(2), dcfg, device="cuda"))
        trace_reqs = _tuning_trace(cfg.vocab_size)
        tuned = _tuning_serve(params, cfg, draft, dcfg, trace_reqs, True)
        plain = _tuning_serve(params, cfg, draft, dcfg, trace_reqs, False)
        del params, draft
        if tuned["tokens"] != plain["tokens"]:
            bad = [i for i, (a, b) in enumerate(zip(tuned["tokens"],
                                                    plain["tokens"]))
                   if a != b]
            raise AssertionError(f"the tuned trace's tokens differ from the "
                                 f"untuned trace's at requests {bad}")
        knobs = [d[2] for d in tuned["decisions"]]
        shrink = [d for d in tuned["decisions"] if d[2] == "spec_tokens"]
        grow = [d for d in tuned["decisions"] if d[2] == "prefix_pages"]
        if not shrink or not grow or not set(knobs) <= {"spec_tokens",
                                                        "prefix_pages"}:
            raise AssertionError(f"the served leg's decisions: "
                                 f"{tuned['decisions']}")
        if not tuned["acceptance"] < 0.5:
            raise AssertionError(f"the untrained draft's acceptance "
                                 f"{tuned['acceptance']}")
        # Every marker of this leg is a decision's, applied in order.
        if [m["tokens"] for m in tuned["markers"]] != [
                [f"{d[2]}={d[3]}"] for d in tuned["decisions"]]:
            raise AssertionError(f"the decisions {tuned['decisions']} and "
                                 f"the markers applied {tuned['markers']}")
        if any(u is not None and u != d for d, u, _ in tuned["depths"]):
            raise AssertionError(f"an iteration's programs ran at another "
                                 f"depth than it ended with: "
                                 f"{tuned['depths']}")
        seen = [d for d, _, _ in tuned["depths"]]
        # A shrink applied in the last iteration's cycle is never adopted.
        if seen[0] != 3 or not 3 - len(shrink) <= seen[-1] < 3 or \
                seen != sorted(seen, reverse=True):
            raise AssertionError(f"the depth by iteration: {seen}")
        for name in ("serving_gemm", "cache_attention"):
            if not tuned["by_form"][f"{name}/sm90"] or \
                    tuned["by_form"][f"{name}/first"]:
                raise AssertionError(f"the served leg's forms: "
                                     f"{tuned['by_form']}")
        kv_free = [f / 512 for _, _, f in tuned["depths"]]
        res["serve"] = {
            "requests": len(trace_reqs), "iterations": tuned["iterations"],
            "decisions": tuned["decisions"], "markers": tuned["markers"],
            "cycles": tuned["cycles"], "counters": tuned["counters"],
            "final": tuned["final"], "acceptance": tuned["acceptance"],
            "kv_free_frac_min_median": [min(kv_free), _pct(kv_free, 0.5)],
            "seconds_tuned": tuned["seconds"],
            "seconds_untuned": plain["seconds"],
            "depth_by_iteration": seen, "bitwise_untuned": True,
            "serving_launches": tuned["serving"],
            "by_form": tuned["by_form"], "other_launches": tuned["other"]}
    finally:
        _tuning_env(saved)
    quant_launches = {k: other_a.get(k, 0) + tuned["other"].get(k, 0)
                      for k in ("quant_pack", "unpack_dequantize")}
    out = {"flash": flash, "serving": tuned["serving"],
           "quant": quant_launches}
    log(smi_line)
    log({"phase": "tuning", "device": smi_line, **res,
         "launches": out, "leg_a_seconds": t_a,
         "seconds": time.perf_counter() - t_phase})
    return out


# -- routing: the fleet router (ROADMAP A.5 item 6) --------------------------

ROUTING_FAMILIES = 6       # header families of the routed traffic (a)
ROUTING_REQUESTS = 48      # requests of the routed traffic (a)
ROUTING_CLIENTS = 8        # client threads of (a)
ROUTING_LONG_TOKENS = 256  # the long request drained mid-generation (b)
ROUTING_DRAIN_AFTER = 16   # its tokens generated before the drain
ROUTING_BURST = 24         # the burst that scales the fleet up (c)
ROUTING_BURST_TOKENS = 32
# The core replicas' names sort after the autoscaler's "auto1", so that
# an idle fleet's ties (equal load, equal affinity) go to the newcomer.
ROUTING_CORE = ("r0", "r1")
ROUTING_COUNTERS = ("routing.requests", "routing.affinity_hits",
                    "routing.affinity_pages", "routing.failovers",
                    "routing.continuations", "routing.replica_deaths",
                    "routing.no_replica_errors", "routing.scale_ups",
                    "routing.scale_downs", "routing.scale_vetoes",
                    "serving.prefix_hits", "serving.prefix_pages_shared",
                    "serving.client_disconnects")


def _routing_traffic(vocab, seed):
    """The seeded traffic: ROUTING_FAMILIES headers of 2-4 full pages
    (32-64 tokens), ROUTING_REQUESTS prompts of a header and a 4-16-token
    suffix asking for 16-32 new tokens, and three fresh headers (3 pages)
    that (a) never sends: the long request's, the pinned one's of (b) and
    the burst's probe tail of (c)."""
    g = np.random.default_rng(seed)
    headers = [g.integers(0, vocab, 16 * int(g.integers(2, 5))).tolist()
               for _ in range(ROUTING_FAMILIES)]
    reqs = []
    for _ in range(ROUTING_REQUESTS):
        h = headers[int(g.integers(0, ROUTING_FAMILIES))]
        reqs.append((h + g.integers(0, vocab, int(g.integers(4, 17))
                                    ).tolist(), int(g.integers(16, 33))))
    fresh = [g.integers(0, vocab, 48).tolist() for _ in range(3)]
    burst = []
    for _ in range(ROUTING_BURST):
        h = headers[int(g.integers(0, ROUTING_FAMILIES))]
        burst.append((h + g.integers(0, vocab, int(g.integers(4, 17))
                                     ).tolist(), ROUTING_BURST_TOKENS))
    tail = g.integers(0, vocab, 20).tolist()
    return headers, reqs, fresh, burst, tail


def _complete_all(engine, reqs):
    """Each (prompt, max_tokens)'s greedy completion by one engine alone
    (batched: a sequence's tokens do not depend on its batch)."""
    handles = [engine.submit(p, max_new_tokens=m) for p, m in reqs]
    engine.run_until_idle()
    return [h.result(timeout=0) for h in handles]


def _http_post(port, payload, timeout=300.0):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _routing_counts(S, fa):
    """The kernel counters: serving's by kernel and form, flash's."""
    return {"serving": dict(S.launches),
            "by_form": {f"{k}/{f}": n for (k, f), n in
                        S.launches_by_form.items()},
            "flash": dict(fa.launches)}


def _counts_delta(a, b):
    return {part: {k: b[part][k] - a[part][k] for k in b[part]}
            for part in b}


def _metric_values(telemetry):
    return {n: telemetry.counter(n).value for n in ROUTING_COUNTERS}


def phase_routing(fa, smi_line, out_dir, seed):
    """The fleet router (ROADMAP A.5 item 6): GPT-2-small replicas (bf16,
    8 slots, page 16, capacity 1024, the prefix cache on, one set of
    weights from ``seed``) as LMServers on private route registries behind
    a Router and a RouterServer with its poll thread, all in this process
    on the card.  (a) ROUTING_REQUESTS seeded requests from
    ROUTING_CLIENTS threads through the router's /generate: every answer
    bitwise one engine's completion, affinity hits, both replicas serving;
    then the same prompts one at a time for one token, direct to the
    replica that served each and through the router, in turns (direct,
    router, router, direct): the router-added latency.  (b) A long request drained mid-generation by
    drain_replica: its 503 partial continued on the survivor, merged
    bitwise; the export's chains donated to the survivor, whose index
    grows, and a follow-up on a donated header routed there with affinity
    and a prefix-cache hit.  (c) FleetAutoscaler (up_load 2, sustain 1,
    cooldown 0) whose launch boots a third replica on the card and whose
    price is the planner's KV and prefix bytes plus the weights' against
    the card's free bytes: during a burst, veto:up while a tensor holds
    the card's memory, then up:auto1, the newcomer seeded before its
    first request, which routes to it with affinity; in the trough
    down:auto1, its chains donated.  (d) A replica's front door closed without a
    drain: ReplicaUnreachable, marked dead, the next dispatches fail over
    bitwise.  The serving kernels launch in the Hopper form only, the
    flash kernels never (asserted, counted a step).  Returns the
    launches."""
    import queue

    import horovod_tpu_torch.telemetry as telemetry
    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.memory import planner
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import serving as S
    from horovod_tpu_torch.routing import (AutoscaleConfig, FleetAutoscaler,
                                           HttpReplicaClient,
                                           ReplicaUnreachable, Router,
                                           RouterConfig, RouterServer,
                                           published_page_hashes)
    from horovod_tpu_torch.serving import InferenceEngine, LMServer
    from horovod_tpu_torch.telemetry import exporter
    from horovod_tpu_torch.utils.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = transformer_lm.bench_config()
    params = tree_map(lambda x: x.detach(), tt.init_transformer(
        torch.Generator().manual_seed(seed), cfg, device="cuda"))
    weight_bytes = sum(t.nbytes for t in tree_leaves(params))

    def engine_of(**kw):
        return InferenceEngine(params, cfg, device="cuda", max_slots=8,
                               page_size=16, capacity=1024, **kw)

    headers, reqs, fresh, burst, tail = _routing_traffic(cfg.vocab_size,
                                                         seed)
    long_prompt = fresh[0] + reqs[0][0][-8:]
    pinned = (fresh[1] + reqs[1][0][-6:], 12)
    follow = (fresh[1] + reqs[2][0][-5:], 12)
    t0 = time.perf_counter()
    single = engine_of()
    single.warm_start()
    want = _complete_all(single, reqs)
    want_long, want_pinned, want_follow = _complete_all(
        single, [(long_prompt, ROUTING_LONG_TOKENS), pinned, follow])
    want_burst = _complete_all(single, burst)
    probes = {i: h + tail for i, h in enumerate(headers)}
    want_probe = dict(zip(probes, _complete_all(
        single, [(p, 16) for p in probes.values()])))
    reference_s = time.perf_counter() - t0
    fp = single.fingerprint.encode()
    del single

    steps = {}
    res = {"seed": seed, "reference_seconds": reference_s}
    servers, clients = {}, {}
    front = None
    counts = _routing_counts(S, fa)
    metrics = {}

    def boot(name):
        srv = LMServer(engine_of(prefix_cache=True), port=0,
                       routes=exporter.RouteRegistry()).start()
        servers[name] = srv
        clients[name] = HttpReplicaClient("127.0.0.1", srv.port)
        return clients[name]

    def step_done(name, t_step):
        nonlocal counts, metrics
        now = _routing_counts(S, fa)
        d = _counts_delta(counts, now)
        counts = now
        m = _metric_values(telemetry)
        steps[name] = {"launches": d,
                       "counters": {k: m[k] - metrics[k] for k in m
                                    if m[k] != metrics[k]},
                       "seconds": time.perf_counter() - t_step}
        metrics = m
        log({"phase": "routing", "step": name, **steps[name]})

    try:
        t_step = time.perf_counter()
        for name in ROUTING_CORE:
            boot(name)
        router = Router(RouterConfig())
        for name in ROUTING_CORE:
            router.add_replica(name, clients[name])
        front = RouterServer(router, port=0, poll_interval=0.1).start()
        res["boot_seconds"] = time.perf_counter() - t_step
        fa.reset_launches()
        S.reset_launches()
        counts = _routing_counts(S, fa)
        m0 = metrics = _metric_values(telemetry)

        # (a) Routed traffic from ROUTING_CLIENTS threads.
        work = queue.Queue()
        for i in range(len(reqs)):
            work.put(i)
        routed = {}

        def client():
            while True:
                try:
                    i = work.get_nowait()
                except queue.Empty:
                    return
                routed[i] = _http_post(front.port, {
                    "tokens": reqs[i][0], "max_tokens": reqs[i][1]})

        threads = [threading.Thread(target=client)
                   for _ in range(ROUTING_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        bad = [i for i in range(len(reqs))
               if routed.get(i, (0,))[0] != 200
               or routed[i][1]["tokens"] != want[i]]
        if bad:
            raise AssertionError(
                f"routing (a): requests {bad} not bitwise one engine's: "
                f"{[routed.get(i) for i in bad[:2]]}")
        served_by = [routed[i][1]["router"]["replica"]
                     for i in range(len(reqs))]
        d = _metric_values(telemetry)
        hits = d["routing.affinity_hits"] - m0["routing.affinity_hits"]
        if hits <= 0 or set(served_by) != set(ROUTING_CORE):
            raise AssertionError(f"routing (a): affinity hits {hits}, "
                                 f"served by {sorted(set(served_by))}")
        # The router's own latency: the same prompts one at a time (no
        # queueing, one serve loop busy), one new token each (a prefill:
        # the hop is the largest share), direct to the replica that
        # served each and through the router, in turns.
        turns = {"router": [], "direct": []}
        for mode in ("direct", "router", "router", "direct"):
            for i, (p, _) in enumerate(reqs):
                port = (front.port if mode == "router"
                        else servers[served_by[i]].port)
                t = time.perf_counter()
                st, r = _http_post(port, {"tokens": p, "max_tokens": 1})
                turns[mode].append(time.perf_counter() - t)
                if st != 200 or r["tokens"] != want[i][:1]:
                    raise AssertionError(f"routing (a): {mode} turn, "
                                         f"request {i}: {st}")
        res["a"] = {
            "requests": len(reqs), "clients": ROUTING_CLIENTS,
            "served": {n: served_by.count(n) for n in ROUTING_CORE},
            "affinity_hits": hits,
            "affinity_pages": d["routing.affinity_pages"]
            - m0["routing.affinity_pages"],
            "bitwise_single_engine": True,
            "latency_ms": {
                mode: {"p50": _pct(v, 0.5) * 1e3, "p99": _pct(v, 0.99) * 1e3}
                for mode, v in turns.items()}}
        res["a"]["router_added_ms"] = {
            q: res["a"]["latency_ms"]["router"][q]
            - res["a"]["latency_ms"]["direct"][q] for q in ("p50", "p99")}
        step_done("a", t_step)

        # (b) A long request drained mid-generation, then the donation.
        t_step = time.perf_counter()
        m1 = _metric_values(telemetry)
        box = {}
        th = threading.Thread(target=lambda: box.update(out=_http_post(
            front.port, {"tokens": long_prompt,
                         "max_tokens": ROUTING_LONG_TOKENS})))
        th.start()

        def holder(n_tokens, prompt_len):
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                for name, srv in servers.items():
                    for _, r in srv.engine.scheduler.active():
                        if r.prompt[:len(long_prompt)] == long_prompt \
                                and len(r.prompt) >= prompt_len \
                                and len(r.generated) >= n_tokens:
                            return name
                time.sleep(0.0005)
            raise AssertionError("routing (b): the long request was never "
                                 "generating")

        victim = holder(1, len(long_prompt))
        survivor = next(n for n in ROUTING_CORE if n != victim)
        # A client pinned to the victim (no router) warms a header only
        # the victim holds; the drain's export carries it.
        st, pin = _http_post(servers[victim].port,
                             {"tokens": pinned[0], "max_tokens": pinned[1]})
        if st != 200 or pin["tokens"] != want_pinned:
            raise AssertionError(f"routing (b): the pinned request {st}")
        holder(ROUTING_DRAIN_AFTER, len(long_prompt))
        before_pages = servers[survivor].engine.cache.prefix_stats()
        t_drain = time.perf_counter()
        export = router.drain_replica(victim)
        drain_call_s = time.perf_counter() - t_drain
        holder(0, len(long_prompt) + 1)  # the continuation, on the survivor
        drain_to_continuation_s = time.perf_counter() - t_drain
        th.join(timeout=600)
        status, merged = box["out"]
        if status != 200 or merged["tokens"] != want_long or \
                merged["router"]["resubmits"] != 1 or \
                merged["router"]["replica"] != survivor:
            raise AssertionError(
                f"routing (b): the continuation {status} "
                f"{merged.get('router')}, tokens bitwise "
                f"{merged.get('tokens') == want_long}")
        drain_to_done_s = time.perf_counter() - t_drain
        chains = export["prefixes"]
        donated_hashes = set(published_page_hashes(
            fp, pinned[0], 16, servers[survivor].engine.cache.pages_per_slot))
        if donated_hashes & set(
                servers[survivor].engine.cache.export_prefix_hashes()):
            raise AssertionError("routing (b): the survivor held the pinned "
                                 "header before the donation")
        mid_pages = servers[survivor].engine.cache.prefix_stats()
        st, _ = clients[survivor].resume({"requests": [],
                                          "prefixes": chains})
        after_pages = servers[survivor].engine.cache.prefix_stats()
        index = set(servers[survivor].engine.cache.export_prefix_hashes())
        if st != 200 or not donated_hashes <= index or \
                after_pages["cached_pages"] <= mid_pages["cached_pages"]:
            raise AssertionError(f"routing (b): the donation {st}, pages "
                                 f"{mid_pages} -> {after_pages}")
        router.poll()
        m2 = _metric_values(telemetry)
        st, fol = _http_post(front.port, {"tokens": follow[0],
                                          "max_tokens": follow[1]})
        m3 = _metric_values(telemetry)
        hits = m3["serving.prefix_hits"] - m2["serving.prefix_hits"]
        if st != 200 or fol["tokens"] != want_follow or \
                fol["router"]["replica"] != survivor or \
                fol["router"]["affinity_pages"] <= 0 or hits != 1:
            raise AssertionError(
                f"routing (b): the follow-up {st} {fol.get('router')}, "
                f"prefix hits {hits}")
        res["b"] = {
            "victim": victim, "survivor": survivor,
            "partial_tokens_before_drain": ROUTING_DRAIN_AFTER,
            "drain_call_ms": drain_call_s * 1e3,
            "drain_to_continuation_ms": drain_to_continuation_s * 1e3,
            "drain_to_merged_ms": drain_to_done_s * 1e3,
            "merged_bitwise": True, "export_chains": len(chains),
            "export_requests": len(export.get("requests") or []),
            "survivor_cached_pages": [before_pages["cached_pages"],
                                      mid_pages["cached_pages"],
                                      after_pages["cached_pages"]],
            "follow_up_affinity_pages": fol["router"]["affinity_pages"],
            "follow_up_prefix_pages_shared":
                m3["serving.prefix_pages_shared"]
                - m2["serving.prefix_pages_shared"],
            "continuations": m3["routing.continuations"]
            - m1["routing.continuations"]}
        # The victim back in the fleet (POST /resume of an empty export).
        st, _ = clients[victim].resume({"requests": [], "prefixes": []})
        router.poll()
        if st != 200 or router.ready_count() != 2:
            raise AssertionError(f"routing (b): resume {st}, ready "
                                 f"{router.replica_status()}")
        step_done("b", t_step)

        # (c) The autoscaler on the card.
        t_step = time.perf_counter()
        hog = []

        def price():
            e = servers[ROUTING_CORE[0]].engine.cache
            return (planner.kv_cache_bytes(
                cfg.n_layers, cfg.n_heads, cfg.d_model // cfg.n_heads,
                8, e.pages_per_slot, 16, "bfloat16")
                + planner.prefix_pages_bytes(
                    cfg.n_layers, cfg.n_heads, cfg.d_model // cfg.n_heads,
                    e.prefix_pages, 16, "bfloat16")
                + weight_bytes)

        def headroom():
            return torch.cuda.mem_get_info()[0]

        launched, retired = [], []

        def launch(name):
            launched.append(name)
            return boot(name)

        def retire(name):
            retired.append(name)
            servers.pop(name).close()

        scaler = FleetAutoscaler(
            router, launch, retire,
            cfg=AutoscaleConfig(min_replicas=2, max_replicas=4, up_load=2.0,
                                down_load=1.0, sustain=1, cooldown=0),
            price=price, headroom=headroom)
        m4 = _metric_values(telemetry)
        bout, pending = {}, [len(burst)]
        plock = threading.Lock()

        def one(i):
            bout[i] = _http_post(front.port, {"tokens": burst[i][0],
                                              "max_tokens": burst[i][1]})
            with plock:
                pending[0] -= 1

        bthreads = [threading.Thread(target=one, args=(i,))
                    for i in range(len(burst))]
        for th in bthreads:
            th.start()
        deadline = time.monotonic() + 120
        while True:  # every burst request dispatched
            st_ = router.replica_status()
            with plock:
                done = len(burst) - pending[0]
            if sum(s["inflight"] for s in st_.values()) + done >= len(burst):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"routing (c): the burst was not "
                                     f"dispatched: {st_}")
            time.sleep(0.001)
        router.poll()
        need = price()
        hog.append(torch.empty(max(0, headroom() - need // 2),
                               dtype=torch.uint8, device="cuda"))
        squeezed = headroom()
        veto = scaler.observe()
        hog.clear()
        torch.cuda.empty_cache()
        t_up = time.perf_counter()
        up = scaler.observe()
        up_s = time.perf_counter() - t_up
        if veto != "veto:up" or up != "up:auto1" or not squeezed < need:
            raise AssertionError(f"routing (c): {veto}, {up}; price {need} "
                                 f"against headroom {squeezed}")
        seeded = servers["auto1"].engine.cache.prefix_stats()
        seeded_index = set(servers["auto1"].engine.cache
                           .export_prefix_hashes())
        # The probe: a header the newcomer was seeded with, and a tail
        # none holds.  The newcomer wins on load while the burst runs, or
        # on its name in a tie.
        fams = [i for i, h in enumerate(headers) if set(
            published_page_hashes(fp, h, 16, 64)) <= seeded_index]
        if not fams:
            raise AssertionError("routing (c): the newcomer was seeded "
                                 "with no whole header")
        fam = fams[0]
        with plock:
            busy = pending[0]
        st, pr = _http_post(front.port, {"tokens": probes[fam],
                                         "max_tokens": 16})
        if seeded["cached_pages"] <= 0 or st != 200 or \
                pr["tokens"] != want_probe[fam] or \
                pr["router"]["replica"] != "auto1" or \
                pr["router"]["affinity_pages"] <= 0:
            raise AssertionError(
                f"routing (c): seeded {seeded}, burst pending {busy}, the "
                f"probe {st} {pr.get('router')}")
        for th in bthreads:
            th.join(timeout=600)
        bad = [i for i in range(len(burst)) if bout[i][0] != 200
               or bout[i][1]["tokens"] != want_burst[i]]
        if bad:
            raise AssertionError(f"routing (c): burst requests {bad} not "
                                 f"bitwise one engine's")
        probe_hashes = set(published_page_hashes(fp, probes[fam], 16, 64))
        pages_before = {n: servers[n].engine.cache.prefix_stats()[
            "cached_pages"] for n in ROUTING_CORE}
        router.poll()
        down = scaler.observe()
        pages_after = {n: servers[n].engine.cache.prefix_stats()[
            "cached_pages"] for n in ROUTING_CORE}
        gained = [n for n in ROUTING_CORE if probe_hashes <= set(
            servers[n].engine.cache.export_prefix_hashes())]
        if down != "down:auto1" or retired != ["auto1"] or \
                router.replica_names() != list(ROUTING_CORE) or \
                not gained or \
                sum(pages_after.values()) <= sum(pages_before.values()):
            raise AssertionError(
                f"routing (c): {down}, retired {retired}, fleet "
                f"{router.replica_names()}, pages {pages_before} -> "
                f"{pages_after}, the probe's chain on {gained}")
        m5 = _metric_values(telemetry)
        res["c"] = {
            "decisions": [veto, up, down], "price_bytes": need,
            "headroom_squeezed_bytes": squeezed,
            "headroom_bytes": headroom(), "scale_up_ms": up_s * 1e3,
            "auto1_seeded_pages": seeded["cached_pages"],
            "probe_affinity_pages": pr["router"]["affinity_pages"],
            "burst_pending_at_probe": busy, "burst_bitwise": True,
            "donated_to": gained, "pages_before_after": [pages_before,
                                                         pages_after],
            "counters": {k: m5[k] - m4[k] for k in (
                "routing.scale_ups", "routing.scale_downs",
                "routing.scale_vetoes")}}
        step_done("c", t_step)

        # (d) A hard death: r0's front door closed without a drain (r0,
        # the tie-break's choice, so a dispatch may meet it first).
        t_step = time.perf_counter()
        m6 = _metric_values(telemetry)
        dead, alive = ROUTING_CORE
        dead_client = clients[dead]
        servers.pop(dead).close()
        try:
            dead_client.health()
            raise AssertionError("routing (d): the closed replica answered")
        except ReplicaUnreachable:
            pass
        stamps = []
        for i in range(8):
            st, r = _http_post(front.port, {"tokens": reqs[i][0],
                                            "max_tokens": reqs[i][1]})
            if st != 200 or r["tokens"] != want[i] or \
                    r["router"]["replica"] != alive:
                raise AssertionError(f"routing (d): dispatch {i}: {st} "
                                     f"{r.get('router')}")
            stamps.append(r["router"])
        m7 = _metric_values(telemetry)
        status = router.replica_status()
        if status[dead]["status"] != "dead" or \
                m7["routing.replica_deaths"] - m6["routing.replica_deaths"] \
                != 1:
            raise AssertionError(f"routing (d): {status}")
        res["d"] = {"dead": dead, "status": status[dead]["status"],
                    "failovers": sum(s["failovers"] for s in stamps),
                    "deaths": m7["routing.replica_deaths"]
                    - m6["routing.replica_deaths"],
                    "bitwise_single_engine": True}
        step_done("d", t_step)
    finally:
        if front is not None:
            front.close()
        for srv in list(servers.values()):
            srv.close()
    total = {"serving": {}, "by_form": {}, "flash": {}}
    for st in steps.values():
        for part, d in st["launches"].items():
            for k, n in d.items():
                total[part][k] = total[part].get(k, 0) + n
    if any(total["flash"].values()):
        raise AssertionError(f"routing: flash launches {total['flash']}")
    for name, st in steps.items():
        for k in S.KERNELS:
            got = st["launches"]
            if got["serving"][k] <= 0 or got["by_form"][f"{k}/first"] or \
                    got["by_form"][f"{k}/sm90"] != got["serving"][k]:
                raise AssertionError(f"routing ({name}): {k} launches "
                                     f"{got}")
    res["counters"] = {k: sum(st["counters"].get(k, 0)
                              for st in steps.values())
                       for k in ROUTING_COUNTERS}
    log(smi_line)
    log({"phase": "routing", "device": smi_line, **res,
         "steps": steps, "launches": total,
         "seconds": time.perf_counter() - t_phase})
    return total


def phase_word2vec(smi_line, out_dir):
    """Skip-gram word2vec with sparse embedding gradients on the card:
    upstream Horovod's examples/tensorflow_word2vec.py configuration
    (vocabulary 50,000, embedding 128, batch 128, 64 negatives, window 2)
    on a seeded Zipf corpus of 1,000,000 tokens, 200 steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import word2vec as ex
    from horovod_tpu_torch.models import word2vec as W
    from horovod_tpu_torch.ops import collective as C

    torch.cuda.empty_cache()
    vocab, dim, batch, negatives, steps, warmup = 50_000, 128, 128, 64, \
        200, 20
    hvd.init(device="cuda")
    C.reset_stats()
    run = ex.train(vocab=vocab, dim=dim, batch=batch, negatives=negatives,
                   steps=steps, corpus_len=1_000_000, device="cuda",
                   timed_from=warmup)
    stats = C.stats()
    model, losses = run["model"], run["losses"]
    if not all(np.isfinite(losses)) or \
            not np.mean(losses[-20:]) < np.mean(losses[:20]):
        raise AssertionError(f"word2vec loss did not fall: {losses[:3]} .. "
                             f"{losses[-3:]}")
    grad = model.embeddings.grad
    tensors = list(model.parameters()) + [p.grad for p in model.parameters()]
    if any(t.device.type != "cuda" for t in tensors) or not grad.is_sparse:
        raise AssertionError("word2vec: a tensor is off the card, or the "
                             "embedding's gradient is not sparse")
    rows = grad.coalesce().values().shape[0]
    sparse_bytes = rows * dim * 4 + rows * 8  # f32 values, int64 indices
    timed_s = run["timed_seconds"]

    # One step on the card against the same step on the CPU, from the
    # same weights and batch (the allreduces of one rank are exact).
    cpu = W.Word2Vec(W.Word2VecParams(*(p.detach().cpu().clone()
                                        for p in model.params())))
    rng = np.random.RandomState(123)
    b_card = ex.batch_tensors(rng, run["corpus"], batch, negatives, vocab,
                              "cuda")
    loss_card = ex.train_step(model, *b_card, 0.2, steps)
    loss_cpu = ex.train_step(cpu, *(t.cpu() for t in b_card), 0.2, steps)
    errs = {"loss": _rel_err(loss_card.cpu(), loss_cpu)}
    for name, p, q in zip(("embeddings", "nce_weights", "nce_biases"),
                          model.params(), cpu.params()):
        errs[name] = _rel_err(p.detach().cpu(), q.detach())
    if max(errs.values()) > 1e-5:
        raise AssertionError(f"word2vec step, card against CPU: {errs}")

    def one_step():
        ex.train_step(model, *ex.batch_tensors(rng, run["corpus"], batch,
                                                negatives, vocab, "cuda"),
                      0.2, steps + 1)

    prof = profile_step(one_step, out_dir, "word2vec")
    log({"phase": "word2vec", "config": "upstream tensorflow_word2vec.py: "
         "vocab 50000, dim 128, batch 128, 64 negatives, window 2; seeded "
         "Zipf corpus of 1,000,000 tokens", "steps": steps,
         "losses_first": losses[:5], "losses_last": losses[-5:],
         "steps_per_s": (steps - warmup) / timed_s,
         "pairs_per_s": (steps - warmup) * batch / timed_s,
         "step_ms": timed_s / (steps - warmup) * 1e3,
         "negotiated_per_step": {k: v / steps for k, v in stats.items()},
         "embedding_rows_last_step": rows,
         "sparse_bytes_per_step": sparse_bytes,
         "dense_bytes": vocab * dim * 4,
         "card_vs_cpu_rel_err": errs, "device": smi_line,
         "profile": {k: prof[k] for k in ("device_busy_ms",
                                          "profiled_step_ms",
                                          "device_idle_share",
                                          "device_events",
                                          "launches_unrecorded",
                                          "enqueue_ms")},
         "top_kernels": prof["top"][:6]})
    hvd.shutdown()


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (or over 1 where want is 0)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max()) / (float(want.abs().max()) or 1.0)


def resnet_card_vs_cpu(hvd, R, space_to_depth):
    """One ResNet18Thin train step (f32 compute, 32 px, batch 8,
    SGD(0.1, momentum 0.9)) from the same parameters: on the card through
    make_train_step_with_state, on the CPU as plain forward, backward and
    SGD (one rank: the step's allreduces are the identity).  Returns the
    worst error of each kind over its tolerance."""
    from horovod_tpu_torch.utils.tree import tree_leaves, tree_map

    model = R.ResNet18Thin(num_classes=16, compute_dtype=torch.float32,
                           space_to_depth=space_to_depth)
    params0, stats0 = R.init_resnet(model, seed=0)
    images, labels = R.synthetic_imagenet(8, image_size=32, num_classes=16)
    loss_fn = R.resnet_loss_fn(model)

    def run(device):
        params = tree_map(lambda x: x.detach().clone().to(device)
                          .requires_grad_(), params0)
        stats = tree_map(lambda x: x.clone().to(device), stats0)
        sgd = torch.optim.SGD(tree_leaves(params), lr=0.1, momentum=0.9)
        batch = (images.to(device), labels.to(device))
        if device == "cpu":
            loss, stats = loss_fn(params, stats, batch)
            loss.backward()
            sgd.step()
        else:
            step = hvd.make_train_step_with_state(
                loss_fn, hvd.DistributedOptimizer(sgd))
            stats, loss = step(params, stats, batch)
            for leaf in tree_leaves([params, stats]):
                if leaf.device.type != "cuda":
                    raise AssertionError("a tensor of the card's step is on "
                                         f"{leaf.device}")
        return loss, stats, params

    card, cpu = run("cuda"), run("cpu")
    errs = {"loss": _rel_err(card[0], cpu[0]) / RESNET_TOL_LOSS,
            "state": max(_rel_err(a, b) for a, b in zip(
                tree_leaves(card[1]), tree_leaves(cpu[1]))) / RESNET_TOL_STATE,
            "update": max(_rel_err(a.cpu() - p0, b - p0) for a, b, p0 in zip(
                tree_leaves(card[2]), tree_leaves(cpu[2]),
                tree_leaves(params0))) / RESNET_TOL_UPDATE}
    bad = {k: v for k, v in errs.items() if not v <= 1.0}
    if bad:
        raise AssertionError(f"ResNet18Thin step (space_to_depth="
                             f"{space_to_depth}), card against CPU, error "
                             f"over tolerance: {errs}")
    return {"err_over_tol": errs, "loss_card": float(card[0]),
            "loss_cpu": float(cpu[0].detach())}


def expected_lr_sequence(base_lr, size, epochs, steps, momentum=0.9):
    """(lr, momentum) at each batch of the --full flow after its callbacks:
    warm-up over epoch 0 (lr * 1/size * (e' * (size - 1) + 1) with e' =
    epoch + (batch + 1) / steps), x0.1 from epoch 2 (staircase); the
    momentum scaled by new/old lr on a batch whose lr was set."""
    out, lr = [], base_lr
    for epoch in range(epochs):
        for b in range(steps):
            new = None
            if epoch < 1:
                e = epoch + b / steps + 1.0 / steps
                new = base_lr / size * (e * (size - 1) + 1)
            elif epoch >= 2 and b == 0:
                new = base_lr * 0.1
            mom = momentum
            if new is not None:
                mom, lr = momentum * new / lr, new
            out.append((lr, mom))
    return out


# resnet phase, the overlapped leg: schedules timed in turns, warm-up and
# timed steps a turn.
RESNET_OVERLAP_TURNS = ("off", "serial", "on", "on", "serial", "off")
RESNET_OVERLAP_WARMUP, RESNET_OVERLAP_STEPS = 2, 5


def resnet_overlap_leg(hvd, R, smi_line, device="cuda", model=None,
                       image_size=224, batch=128):
    """ResNet-50 overlapped: bench.py's recipe (space-to-depth stem, 224
    px, batch 128, bf16 compute, SGD(0.1, momentum 0.9)) through
    make_train_step_with_state with overlap off, serial and on, from the
    same weights and batch, cuDNN's deterministic algorithms.  Held: 3
    steps bitwise across the three schedules (losses, parameters, BN
    statistics); one fused response a bucket plus the loss's and no cache
    miss after the first step; every tensor on the device; no flash
    launch (ResNet runs none of the port's kernels).  Logged: step ms in
    turns, buckets a step, overlap.exposed_comm_seconds a step and the
    leg's seconds.  One rank moves no byte on the wire: no gain is
    claimed.  ``device``, ``model``, ``image_size`` and ``batch`` let a
    CPU rehearsal run it small."""
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.utils.tree import tree_leaves, tree_map

    t_leg = time.perf_counter()
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    model = model or R.ResNet50(num_classes=1000, space_to_depth=True)
    params0, stats0 = R.init_resnet(model, seed=0, device=device)
    images, labels = R.synthetic_imagenet(batch, image_size=image_size,
                                          num_classes=1000)
    data = hvd.shard_batch((images, labels))
    loss_fn = R.resnet_loss_fn(model)

    def build(mode):
        params = tree_map(lambda x: x.detach().clone().requires_grad_(),
                          params0)
        stats = tree_map(lambda x: x.clone(), stats0)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(
            tree_leaves(params), lr=0.1, momentum=0.9))
        return params, stats, hvd.make_train_step_with_state(
            loss_fn, opt, overlap=mode)

    def responses_ok(mode, step, st, steps):
        """One fused response a bucket and the loss's a step, all from
        the cache; the monolithic step negotiates the loss alone."""
        buckets = step.bucket_count if mode != "off" else 0
        if mode != "off" and not step.overlap_active:
            raise AssertionError(f"resnet overlap {mode}: fell back "
                                 f"({step._fallback_reason})")
        if st["responses"] != steps * (buckets + 1) or \
                st["cache_misses"] != 0:
            raise AssertionError(f"resnet overlap {mode}: {st} over "
                                 f"{steps} steps for {buckets} buckets")
        return buckets

    cudnn = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    fa.reset_launches()
    try:
        # 1. Bitwise: 3 steps of each schedule from the same start.
        runs = {}
        for mode in ("off", "serial", "on"):
            params, stats, step = build(mode)
            losses = []
            for i in range(3):
                stats, loss = step(params, stats, data)
                losses.append(loss)
                if i == 0:
                    C.reset_stats()
            buckets = responses_ok(mode, step, C.stats(), 2)
            leaves = tree_leaves([params, stats]) + losses
            if any(x.device.type != device for x in leaves):
                raise AssertionError(f"resnet overlap {mode}: a tensor is "
                                     f"not on {device}")
            runs[mode] = ([float(x) for x in losses],
                          [x.detach().clone() for x in leaves[:-3]],
                          buckets)
            del params, stats, step, leaves
        off = runs["off"]
        for mode in ("serial", "on"):
            got = runs[mode]
            if got[0] != off[0] or not all(
                    torch.equal(a, b) for a, b in zip(got[1], off[1])):
                raise AssertionError(
                    f"resnet overlap {mode} differs from off: "
                    f"{ {m: r[0] for m, r in runs.items()} }")
        if not all(np.isfinite(off[0])) or not off[0][-1] < off[0][0]:
            raise AssertionError(f"resnet overlap losses: {off[0]}")
        losses, buckets = off[0], runs["on"][2]
        del runs, off, got
        if cuda:
            torch.cuda.empty_cache()

        # 2. Timed in turns.
        timed = {mode: [] for mode in ("off", "serial", "on")}
        for mode in RESNET_OVERLAP_TURNS:
            params, stats, step = build(mode)
            for _ in range(RESNET_OVERLAP_WARMUP):
                stats, loss = step(params, stats, data)
            sync()
            C.reset_stats()
            before = step.stats() if mode != "off" else None
            t0 = time.perf_counter()
            for _ in range(RESNET_OVERLAP_STEPS):
                stats, loss = step(params, stats, data)
            sync()
            seconds = time.perf_counter() - t0
            row = {"step_ms": seconds / RESNET_OVERLAP_STEPS * 1e3,
                   "buckets_per_step": responses_ok(
                       mode, step, C.stats(), RESNET_OVERLAP_STEPS)}
            if mode != "off":
                ex0 = before["overlap.exposed_comm_seconds"]
                ex1 = step.stats()["overlap.exposed_comm_seconds"]
                row["exposed_comm_ms_per_step"] = (
                    (ex1["sum"] - ex0["sum"]) / RESNET_OVERLAP_STEPS * 1e3)
            timed[mode].append(row)
            del params, stats, step, loss
            if cuda:
                torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = cudnn
    flash = dict(fa.launches)
    if any(flash.values()):
        raise AssertionError(f"resnet overlap: flash kernels launched: "
                             f"{flash}")
    out = {"phase": "resnet_overlap",
           "check": "ResNet-50 space-to-depth, 224 px, batch 128, bf16, "
                    "3 steps: off == serial == on bitwise (losses, "
                    "parameters, BN statistics), one response a bucket "
                    "and the loss's, no cache miss after step 1",
           "losses": losses, "buckets_per_step": buckets,
           "flash_launches": flash, "cudnn": "deterministic",
           "turns": list(RESNET_OVERLAP_TURNS),
           "warmup": RESNET_OVERLAP_WARMUP,
           "timed_steps": RESNET_OVERLAP_STEPS, **timed,
           **{f"{m}_mean_step_ms": float(np.mean(
               [r["step_ms"] for r in rows])) for m, rows in timed.items()},
           "seconds": time.perf_counter() - t_leg, "device": smi_line}
    log(out)
    return out


def phase_resnet(smi_line, out_dir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks
    from horovod_tpu_torch.examples import resnet50_synthetic as ex
    from horovod_tpu_torch.models import layers
    from horovod_tpu_torch.models import resnet as R
    from horovod_tpu_torch.utils.tree import tree_leaves

    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init(device="cuda")
    # The asymmetric SAME pads keep the channels_last layout on the card.
    x = torch.randn(8, 56, 56, 16, device="cuda").permute(0, 3, 1, 2)
    w = layers.oihw(torch.randn(3, 3, 16, 16, device="cuda"), torch.float32)
    for name, y in (("conv_same", layers.conv_same(x, w, 2)),
                    ("max_pool_same", layers.max_pool_same(x, 3, 2))):
        if y.shape[2:] != (28, 28) or not y.is_contiguous(
                memory_format=torch.channels_last):
            raise AssertionError(f"{name}: shape {tuple(y.shape)}, "
                                 f"strides {y.stride()}")
    card_vs_cpu = {f"space_to_depth={s2d}": resnet_card_vs_cpu(hvd, R, s2d)
                   for s2d in (False, True)}
    log({"phase": "resnet", "check": "ResNet18Thin step, card against CPU "
         "(f32, TF32 off, 32 px, batch 8)", "result": card_vs_cpu})

    # The --full example flow: Trainer.fit, four callbacks, prefetch 2.
    seen = []

    class Spy(callbacks.Callback):
        def on_batch_begin(self, batch, logs=None):
            seen.append((self.trainer.lr, self.trainer.momentum))

    epochs = 3
    t0 = time.perf_counter()
    flow = ex.fit(full=True, epochs=epochs, device="cuda", prefetch=2,
                  extra_callbacks=[Spy(), callbacks.MetricsLogger()])
    flow_s = time.perf_counter() - t0
    trainer, history = flow["trainer"], flow["history"]
    losses = [h["loss"] for h in history]
    # MetricsLogger put the control plane's counts into every epoch's logs.
    if not all(h.get("hvd/collective.submitted", 0) >= 1
               and "hvd/handles.live" in h for h in history):
        raise AssertionError(f"MetricsLogger's epoch logs: {history}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {history}")
    want = expected_lr_sequence(flow["base_lr"], hvd.size(), epochs,
                                ex.STEPS_PER_EPOCH)
    if len(seen) != len(want) or any(
            abs(a - c) > 1e-9 * c or abs(b - d) > 1e-9 * d
            for (a, b), (c, d) in zip(seen, want)):
        raise AssertionError(f"LR/momentum sequence {seen}, want {want}")
    leaves = tree_leaves([trainer.params, trainer.model_state])
    if any(leaf.device.type != "cuda" for leaf in leaves):
        raise AssertionError("a parameter or statistic is not on the card")
    means = [v for k, v in _named_leaves(trainer.model_state)
             if k.endswith("mean")]
    if not all(bool(m.abs().max() > 0) for m in means):
        raise AssertionError("a BatchNorm running mean never moved")
    with hvd.prefetch_to_device(
            (flow["batches"](0, s) for s in range(2)), depth=2) as staged:
        for s, batch in enumerate(staged):
            want_batch = hvd.shard_batch(flow["batches"](0, s))
            for got, ref in zip(batch, want_batch):
                if got.device.type != "cuda" or not torch.equal(got, ref):
                    raise AssertionError("a prefetched batch differs from "
                                         "shard_batch's or is off the card")
    log({"phase": "resnet_flow", "model": "ResNet-50", "image_size": 224,
         "batch": 32, "epochs": epochs, "steps_per_epoch": ex.STEPS_PER_EPOCH,
         "history": history, "lr_momentum": seen, "seconds": flow_s,
         "device": smi_line})
    del flow, trainer, leaves, means
    torch.cuda.empty_cache()

    # bench.py's recipe.
    batch, warmup, iters = 128, 3, 20
    torch.cuda.reset_peak_memory_stats()
    run = ex.bench(batch=batch, image_size=224, warmup=warmup, iters=iters,
                   space_to_depth=True, device="cuda")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = run["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bench loss not finite and falling: {losses}")
    if any(leaf.device.type != "cuda" for leaf in tree_leaves(
            [run["params"], run["stats"], run["data"]])):
        raise AssertionError("a tensor of the bench step is not on the card")
    tflops = ex.RESNET50_TRAIN_FLOPS_PER_IMAGE * run["images_per_sec"] / 1e12
    log({"phase": "resnet_bench", "model": "ResNet-50 space-to-depth",
         "params": run["n_params"], "batch": batch, "image_size": 224,
         "dtype": "bfloat16", "warmup": warmup, "timed_steps": iters,
         "losses": losses, "step_ms": run["step_ms"],
         "images_per_s": run["images_per_sec"], "peak_mem_gb": peak_gb,
         "analytic_tflops": tflops, "share_of_989_tflops": tflops / 989.0,
         "device": smi_line})
    # The host's share: time for step() to return (its launches enqueued)
    # against the whole step, unprofiled.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run["one_step"]()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    log({"phase": "resnet_host", "enqueue_ms": (t1 - t0) * 1e3,
         "step_ms": (time.perf_counter() - t0) * 1e3, "device": smi_line})
    prof = profile_step(run["one_step"], out_dir, "resnet")
    log({"phase": "resnet_profile", "device": smi_line, **prof})
    del run
    torch.cuda.empty_cache()
    resnet_overlap_leg(hvd, R, smi_line)
    hvd.shutdown()


def _named_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def main() -> int:
    # A crash in native code (a kernel launcher, the native coordinator)
    # prints every thread's Python stack before the process dies.
    faulthandler.enable()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--out-dir", default=os.path.join(HERE, "build",
                                                      "chip_smoke"),
                    help="where the profiled step's table and chrome "
                         "trace go")
    ap.add_argument("--observe-child", default=None, metavar="JSON",
                    help=argparse.SUPPRESS)  # the observe phase's child
    # The elastic phase's children: a training incarnation under the
    # elastic launcher ("train", "retry"), the serving relaunch ("serve").
    ap.add_argument("--elastic-child", default=None,
                    choices=("train", "retry", "serve"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--elastic-result", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--elastic-die-at", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--elastic-payload", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=21,
                    help="the routing phase's weights and traffic")
    # The control phase's child: one CPU rank of a GPT-2-small run.
    ap.add_argument("--control-child", default=None, metavar="PATH",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.observe_child:
        sys.path.insert(0, HERE)
        os.makedirs(args.out_dir, exist_ok=True)
        return observe_child(args.observe_child, args.out_dir)
    if args.control_child:
        sys.path.insert(0, HERE)
        return control_child(args.control_child)
    if args.elastic_child:
        sys.path.insert(0, HERE)
        if args.elastic_child == "serve":
            return elastic_serve_child(args.elastic_result,
                                       args.elastic_payload)
        return elastic_train_child(args.elastic_child, args.elastic_result,
                                   args.elastic_die_at)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases: {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on a "
              "GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "horovod_tpu_torch")):
        print("chip_smoke: the horovod_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    global LOG_FILE
    os.makedirs(args.out_dir, exist_ok=True)
    LOG_FILE = os.path.join(args.out_dir, "chip_smoke.log")
    open(LOG_FILE, "w").close()
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    smi = nvidia_smi_line()
    log(smi)
    log({"phase": "device", "nvidia_smi": smi,
         "name": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count(), "torch": torch.__version__,
         "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    t0 = time.perf_counter()
    _build.build_all()
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "sources": list(_build.SOURCES)})
    main_case = phase_kernels(fa) if "kernels" in phases else None
    if "long" in phases:
        phase_long(fa)
    launches = (phase_trainer(fa, smi, args.out_dir) if "trainer" in phases
                else None)
    gpt3 = (phase_gpt3_large(fa, smi, args.out_dir) if "gpt3_large" in phases
            else None)
    if "eager" in phases:
        phase_eager(fa, smi, args.out_dir)
    quant = (phase_quant(fa, smi, args.out_dir) if "quant" in phases
             else None)
    if "overlap" in phases:
        phase_overlap(fa, smi, args.out_dir)
    parallel = (phase_parallel(fa, smi, args.out_dir) if "parallel" in phases
                else None)
    sharded = (phase_sharded(fa, smi, args.out_dir) if "sharded" in phases
               else {})
    pipeline = (phase_pipeline(fa, smi, args.out_dir) if "pipeline" in phases
                else None)
    checkpoint = (phase_checkpoint(fa, smi, args.out_dir)
                  if "checkpoint" in phases else None)
    serving = (phase_serving(fa, smi, args.out_dir) if "serving" in phases
               else None)
    serving_mp = (phase_serving_mp(fa, smi, args.out_dir)
                  if "serving_mp" in phases else None)
    distill = (phase_distill(fa, smi, args.out_dir) if "distill" in phases
               else None)
    observe = (phase_observe(fa, smi, args.out_dir) if "observe" in phases
               else None)
    elastic = (phase_elastic(fa, smi, args.out_dir) if "elastic" in phases
               else None)
    # The control channel is host code; the phase's kernel launches are
    # the chaos matrix's local scenarios on the card.
    control = (phase_control(smi, args.out_dir) if "control" in phases
               else None)
    tuning = (phase_tuning(fa, smi, args.out_dir) if "tuning" in phases
              else None)
    routing = (phase_routing(fa, smi, args.out_dir, args.seed)
               if "routing" in phases else None)
    if "word2vec" in phases:
        phase_word2vec(smi, args.out_dir)
    if "resnet" in phases:
        phase_resnet(smi, args.out_dir)
    if main_case is None or launches is None:
        log({"phase": "done", "phases": phases})
        return 0

    # The main path's kernels: bf16 at head_dim 64 runs the redesigned
    # forward, dK/dV and dQ (the .cuh files, built into flash_fwd.cu and
    # flash_bwd.cu).
    sources = {
        "flash_fwd": "horovod_tpu_torch/ops/csrc/flash_fwd_sm90.cuh",
        "flash_bwd_dkdv": "horovod_tpu_torch/ops/csrc/flash_bwd_dkdv_sm90.cuh",
        "flash_bwd_dq": "horovod_tpu_torch/ops/csrc/flash_bwd_dq_sm90.cuh"}
    replaces = {
        "flash_fwd": "horovod_tpu/ops/flash_attention.py:133",
        "flash_bwd_dkdv": "horovod_tpu/ops/flash_attention.py:387",
        "flash_bwd_dq": "horovod_tpu/ops/flash_attention.py:431"}
    kernels = []
    for name in fa.KERNELS:
        r = main_case[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # Each path's own count, zeroed just before it was driven.
            "launches_by_path": {
                "trainer": launches[name],
                **({"parallel": parallel[name]} if parallel else {}),
                **{path: counts[name] for path, counts in sharded.items()
                   if path != "monolithic"},
                **({"pipeline": pipeline[name]} if pipeline else {}),
                **({"checkpoint": checkpoint[name]} if checkpoint else {}),
                **({"serving": serving["flash_launches"][name]}
                   if serving else {}),
                **({"distill": distill["launches"][name]}
                   if distill else {}),
                **({"observe": observe["launches"]["hook"][name]}
                   if observe else {}),
                **({"elastic": elastic["flash"][name]}
                   if elastic else {}),
                **({"control": control["launches"]["total"][name]}
                   if control else {}),
                **({"tuning": tuning["flash"][name]} if tuning else {}),
                **({"routing": routing["flash"][name]}
                   if routing else {})}})
    # GPT-3 Large's path: the same three kernels at bf16 head_dim 96 (the
    # Hopper forms' partial second panel); launches counted at that
    # (form, head_dim).  The other widths and forms the phase times (d80,
    # f32, s8192) run on no path: they stay in its gpt3_large_kernels lines.
    if gpt3 is not None:
        label = GPT3_FLASH_CASES[0][0]
        for name in fa.KERNELS:
            r = gpt3["flash"][label][name]
            kernels.append({
                "name": name, "route": "cuda", "source": sources[name],
                "replaces": replaces[name],
                "launches": gpt3["launches"][name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "form": "sm90", "head_dim": 96, "case": label,
                "launches_by_path": {"gpt3_large": gpt3["launches"][name]}})
    # The quantized allreduce's codec (no Pallas counterpart: the
    # reference compiles it into its XLA megakernel), timed at the
    # embedding's bucket in bf16; launches from the int8 hook path.
    if quant is not None:
        r = quant["result"]
        for name, replaces in (
                ("quant_pack", "horovod_tpu/ops/compression.py:510"),
                ("unpack_dequantize", "horovod_tpu/ops/compression.py:535")):
            kernels.append({
                "name": name, "route": "cuda",
                "source": "horovod_tpu_torch/ops/csrc/quant.cu",
                "replaces": replaces, "launches": quant["launches"][name],
                "max_abs_err": r[f"{name}_max_abs_err"],
                "ms": r[f"{name}_ms"],
                "plain_ms": r[f"{name}_plain_ms"],
                "bound_ms": r[f"{name}_bound_ms"],
                "bound_by": r.get(f"{name}_bound_by", "bytes"),
                "library_ms": None,
                **({"form": r["form"],
                    "first_form_ms": r["quant_pack_first_form_ms"]}
                   if name == "quant_pack" else {}),
                **({"launches_by_path": {"tuning": tuning["quant"][name]}}
                   if tuning else {})})
    # The serving path's kernels (no Pallas counterpart: the reference's
    # serving half is jnp), timed at the decode shape: the FFN-in product
    # at M = 16 (8 slots x a width-2 block) and the attention at b8 s2
    # over a capacity of 1024; launches from the continuous leg.  Both
    # run their Hopper form there; first_form_ms is the first form's bf16
    # build on the same inputs, timed in turns with it.
    if serving is not None:
        for name, case, replaces, library in (
                ("serving_gemm", "gemm_w_in_M16",
                 "horovod_tpu/models/transformer.py:556,564,210,213,570 "
                 "(jnp.dot; no Pallas kernel)", "torch.matmul"),
                ("cache_attention", "attention_decode",
                 "horovod_tpu/models/transformer.py:458 (jnp.einsum "
                 ":480,:492; no Pallas kernel)",
                 "scaled_dot_product_attention, f32, boolean mask")):
            r = serving["cases"][case]
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"horovod_tpu_torch/ops/csrc/{name}_sm90.cuh",
                "replaces": replaces, "launches": serving["launches"][name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "form": r["form"], "first_form_ms": r["first_form_ms"],
                "library": library, "case": case,
                "launches_by_path": {
                    "serving": serving["launches"][name],
                    **({"follower": serving_mp["launches"][name],
                        "played_axis": serving_mp["axis"][
                            "played_launches"][name]}
                       if serving_mp else {}),
                    **({"observe": observe["launches"]["served"][name]}
                       if observe else {}),
                    **({"elastic": elastic["serving"][name]}
                       if elastic else {}),
                    **({"control": control["launches"]["total"][name]}
                       if control else {}),
                    **({"tuning": tuning["serving"][name]}
                       if tuning else {}),
                    **({"routing": routing["serving"][name]}
                       if routing else {})}})
    # GPT-3 Large's serving kernels, timed at the decode shape:
    # cache_attention at hd 96 on its Hopper form; the logits product at
    # vocab 50257 on serving_gemm's first form.  Launches by form from
    # the GPT-3 Large engine's continuous leg.
    if gpt3 is not None:
        served = gpt3["serving"]["launches_continuous"]
        for case, name, source in (
                ("attention_decode", "cache_attention",
                 "cache_attention_sm90.cuh"),
                ("gemm_logits_M16", "serving_gemm", "serving.cu")):
            r = gpt3["serving_cases"][case]
            count = served["by_form"][f"{name}/{r['form']}"]
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"horovod_tpu_torch/ops/csrc/{source}",
                "replaces": (
                    "horovod_tpu/models/transformer.py:458 (jnp.einsum "
                    ":480,:492; no Pallas kernel)" if name == "cache_attention"
                    else "horovod_tpu/models/transformer.py:570 (jnp.dot; "
                    "no Pallas kernel)"),
                "launches": count, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "form": r["form"],
                **({"first_form_ms": r["first_form_ms"]}
                   if "first_form_ms" in r else {}),
                "case": f"gpt3_large {case}",
                "launches_by_path": {"gpt3_large": count}})
    log(smi)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
