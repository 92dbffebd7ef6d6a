#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA Hopper card (compute capability 9.0), the CUDA toolkit's ``nvcc``
and PyTorch built for CUDA; it imports nothing of JAX or ``paddle_tpu``.
Phases, in order (any failure exits non-zero and prints no result):

1. card: the ``nvidia-smi`` name and power limit, the capability;
2. build: ``csrc/*.cu`` -> ``build/kernels/`` with ``nvcc`` for sm_90a,
   then the registers and spills of every K1/K3/K4/K5 instantiation
   (``-Xptxas -v``; a bf16 or fp16 K1, K3a, K3b-dkv, K3b-dq, K4 or K5
   body, or an instantiation of the fp32 paged body, that
   spills fails the run), the tensor-core instructions (HMMA) and
   atomics (RED, ATOM) that ``cuobjdump -sass`` finds in each bf16 and
   fp16 K1, K3, K4 and K5 body and the fp32 paged
   body (no HMMA in a tensor-core body fails the run, and so do
   atomics in the K3b-dq body, whose dQ is written once, and any HMMA in
   the fp32 body), and the bf16 K1's, K3 and K5 bodies' shared memory and
   CTAs per SM from the CUDA runtime (K4's: the clusters the card holds
   at once);
3. kernels: K2 LayerNorm (also at a large mean, an odd C, on an
   offset view and at phase 7's shapes and epsilons, K2_PATH, with and
   without w and b, each held to K2_TOL as well),
   K4 paged decode and K5 chunk prefill, each
   against its plain PyTorch version in fp32 and bf16 (and fp16 at
   FP16_CASES' shapes) at the serving
   path's shapes, on pools poisoned where no query may read (1e9 in
   unreadable rows of mapped blocks, NaN in blocks no table names; for
   the kernel alone also NaN in every unreadable row), with
   device times beside the plain version, one library call and the
   card's lower bound; then the int8 branches of K4 and K5 on int8 code
   pools with (block, head) scales, poisoned with saturated codes (127)
   in every row no query may read and a 1e7 scale in every block no
   table names (NaN scales there for the kernel alone). K4 at the decode
   step (8 slots), a lone request at t 1000, a verify of 4 drafts (s 5),
   slots running off tables of 5 blocks of 16 rows (s 5) and 3 of 11
   (s 16), verifies of 16 and 31 drafts (s 17 and 32, two row tiles)
   and 80 rows on 2 slots, over both pools; K5 also
   on a chunk running off a table of 5 blocks, and with bf16 q (its
   tensor-core body) on three slots at their own starts. Every bf16 and
   fp16 K4 case is held to K4_TOL (fp16 to its own limits), every bf16
   and fp16 K5 case to K5_TOL and every fp32 K4 and K5 case to
   F32_PAGED_TOL as well, element by element, and a bf16 or fp16 q, or
   an fp32 q's K pool, misaligned for cp.async must be refused by K4's
   and by K5's C entry point; K4 (the decode step, a verify of 4, the
   table of 3 blocks of 11 rows) and K5 (the deepest prefix, a chunk of
   100) also at the other head dims, HEAD_DIM_GEOMETRIES (128 at 16
   heads, 16, 8 and 32), over both pools in fp32, bf16 and fp16, each to
   the same gates (the shared one, over int8 pools, against the fp32
   plain version there);
4. flash: K1 (forward), K3a (fused backward) and K3b (the streaming
   dK/dV and dQ passes) against their plain versions in fp32 and bf16
   (and in fp16 at the training shape and S 8320, with q and k scaled
   so the largest logits reach ~1e4, each held to the fp16 gates)
   at the training shape, non-causal, at head_dim 128, at BERT-base's
   (32, 512, 12, 64) non-causal in bf16 (phase 7a's), and on the
   long-context route (S 8320, through ``F.scaled_dot_product_attention``
   and ``.backward()``, whose launch counters must show the streaming
   pair and not the fused kernel), with the same timings; K1 also on
   ragged lengths, Sq != Sk, GPT's per-head qkv views (taken without a
   copy; also gpt_tiny's 4 heads of 16), ragged lengths at head dims
   8, 16 and 32, a view misaligned by one element (copied for bf16) and
   inputs
   with NaN past S, and a misaligned pointer that its C entry point must
   refuse; every K1 case is held to FLASH_TOL and to K1_TOL (lse
   absolutely, O element by element); K3a, K3b-dkv and K3b-dq on the
   same cases (with a dO, lse from K1 as in training), on the timed
   shapes and at S 8320, each held to FLASH_TOL and to K3_TOL (dQ, dK,
   dV element by element), and misaligned pointers their C entry points
   must refuse; SDPA's backward alone (and its forward + backward) is
   the K3 rows' yardstick; the fp16 bodies run every K1 and K3 case as
   well, at unit scale, each held to the fp16 gates;
5. serving: ``gpt2_small`` at full width and depth (random weights from a
   seed) serves 16 requests through ``ServingEngine`` on the card; the
   kernels' launch counters must equal what the engine's own chunk and
   step counts imply, and every greedy token must equal the argmax of a
   teacher-forced no-cache forward (near-ties counted, not failed);
5b. int8 serving with the prefix cache: the same model behind
   ``ServingEngine(kv_dtype="int8", prefix_cache=PrefixCache(...))``
   serves 16 requests that share a 512-token system prompt; the int8
   kernels' counters must equal the chunk and step counts (the fp ones
   stay 0), the trie must hold every block left in use, the greedy
   tokens must equal a run of the same trace with the cache off, and
   their agreement with the fp32 teacher-forced argmax must reach 0.9;
5c. bf16 serving: ``gpt2_small`` in bf16 (full width and depth) serves
   phase 5's first 8 greedy requests on bf16 pools, then on int8 pools,
   so that prefill runs K5's and decode K4's tensor-core bodies end to
   end: exact launch counts, and greedy agreement with the bf16
   teacher-forced argmax of at least 0.9;
5d. speculative serving: ``ServingEngine(spec=NgramDrafter(k=4))``,
   whose decode half is a verify running K4 at s = 5 through the block
   table: the position-keyed draws equal the CPU's bits; phase 5's trace
   on the fp32 model (launch counts L x verify steps for K4, L x chunks
   for K5, (2L + 1) x (chunks + verify steps) for K2; greedy tokens
   against the teacher-forced argmax as in phase 5), then 5c's 8 greedy
   requests on the bf16 model over bf16 and int8 pools, and over bf16
   pools at k = 16 (a verify of 17 rows a slot, K4's two row tiles;
   exact counts, agreement >= 0.9 each); the spec keys of
   ``aggregate()`` and the host-clock perf beside phases 5 and 5c;
5e. dense serving: phase 5's fp32 model and trace behind
   ``ServingEngine`` with ``block_size`` at its default (the dense
   arena): greedy tokens against the teacher-forced argmax, K4 and K5
   launched 0 times, K2 (2L + 1) x (chunks + steps); the host-clock
   perf beside phase 5's; then 5b's shared-prompt trace on the dense
   arena with and without a ``PrefixCache`` (cached chunks copied into
   the slot's rows): greedy tokens equal, prefix hits > 0, K4 = K5 = 0;
5f. ``generate()``: the fp32 model, batch 4 of 256-token prompts, 32 new
   tokens, ``top_k=1``, with ``use_cache=True``, ``use_cache=False`` and
   ``jit=True``: each path's tokens the teacher-forced argmax of its
   own sequence but at near-ties, K1 launched L times in every forward
   the flash gate admits, K2 (2L + 1) times a forward;
5g. draft-model speculation: the fp32 model as the target on the paged
   arena and then the dense one, 5c's 8 greedy requests with
   ``DraftModelDrafter(draft, k=4)``: a self-draft (the target's weights)
   accepting >= 0.9 x accept_cap (3) a verify, and a 2-layer draft at
   the target's width whose tokens are the argmax's (near-ties
   counted) as the run without speculation; exact counts for the
   target's K4/K5 and K2 over target and draft;
5h. fp16 serving: ``gpt2_small`` in fp16 at full width and depth serves
   5c's 8 greedy requests on fp16 pools, then on int8 pools (K2's, K4's
   and K5's fp16 bodies): finite teacher-forced logits, exact launch
   counts, greedy agreement with the fp16 teacher-forced argmax >= 0.9;
5i. the host tier: phase 5's fp32 model and trace on pools poisoned
   after the warm-up, fp32 then int8: a roomy run, a run starved to
   ``TIER_POOL`` blocks without a tier and one with
   ``host_tier_blocks=TIER_POOL``: the roomy run's greedy tokens (near
   ties counted), preemptions, blocks spilled and swapped back and
   re-prefill tokens avoided > 0, fewer prefill tokens computed than
   without a tier, exact launch counts, tier and pool empty at the end;
   then 5b's trace behind a ``PrefixCache`` whose budget holds 3 chunks
   with a tier: demotions and host hits > 0 and the cache-off run's
   greedy tokens;
5j. serving telemetry and request-scoped resilience (run after 5d):
   (a) ``logit_guard=True`` with ``fault_injection.nan_kv`` armed at
   ``serving:tick`` on slot 0's first decoding tick, over fp32 pools
   (phase 5's trace), bf16 pools (the bf16 model, 5c's 8 requests) and
   int8 pools (the fp32 model, 5c's 8 requests): exactly the poisoned
   request ends "error", counted under
   ``serving_request_errors_total{where="logit_guard"}``, its tokens a
   prefix of its clean run's, the others' greedy tokens the clean run's
   (near-ties counted), a clean ``audit()``, the blocks it released
   scrubbed to 0, and a clean guarded run launching K2, K4 and K5
   exactly as often as the same trace unguarded (with the same
   tokens); then a poisoned shared prefix of 5b's trace: the request
   that splices it ends "error" before any token (K5's first token),
   requests that share nothing serve a clean run's tokens; (b) phase
   5's trace with ``profile=True`` and the watchdog armed at 30 s:
   phase 5's tokens, top-level coverage >= 0.95, and printed: each
   phase's share of the tick wall, the dispatch ledger's enqueue and
   device window per warm decode and prefill dispatch, and the
   telemetry volume per decode step; then phase 5's trace with the
   default ``Telemetry`` and with one whose every emit is dropped, 4
   runs each in the order on, off, off, on, on, off, off, on: phase
   5's tokens and launches each time,
   and the two arms' walls and decode step p50 (the telemetry's cost,
   host clock, not gated); (c) dispatch faults on 5c's 8
   requests: a 0.2 s sleep at one warm decode dispatch under
   ``dispatch_stall_s=0.05`` (exactly one ``dispatch_stall``), a raise
   on a dispatch's first attempt (one counted retry), a raise at
   ``serving:tick`` (one counted engine error, the trace finished),
   each with the clean run's tokens. Every engine of 5j absorbs
   exactly the planted failure, and every serving run of phase 5 with
   nothing planted absorbs none (no retried dispatch, quarantined
   request, crashed tick, stall or degraded swap: ``_check_absorbed``);
5k. the front door and the fleet on phase 5's fp32 model: (a) a
   ``FrontDoor`` (tenants ``paid`` weight 4 tier 0, ``free`` weight 1
   tier 1, the tick profiler on) takes phase 5's 16 prompts from two
   threads mid-flight in a sampling mix (greedy, top-k 1, temperature
   0.8, top-k 40, top-p 0.9) plus 4 top-k 1 twins of greedy requests, a
   queued and a running cancel and a deadline no request can meet: greedy
   and top-k 1 tokens equal phase 5's (near-ties counted), each twin its
   greedy request's, the cancelled and expired requests release every
   block (a clean ``audit()``), 2 argument signatures across the mix and
   exact K2/K4/K5 launch counts; (b) a live greedy and a live sampled
   request as byte frames mid-flight, restored on a second engine over
   the same weights (``swap_in``) to the uninterrupted run's tokens, and a
   flipped payload byte restoring ``corrupt_fallback``; (c) two
   ``engine_proc`` processes on the card behind a ``FleetRouter``: phase
   5's first 8 requests, one migrated mid-stream, the engine under
   another killed (SIGKILL) mid-stream, both token-exact against phase 5,
   the shutdown drained with a clean audit, and each process's own K2,
   K4 and K5 launches (its ops plane's ``kernel_launches`` before the
   kill, its ``EXIT`` line after) non-zero; the phase's wall, the tick's
   shares and the decode step p50 printed (host clock);
5l. adapters, grammars, score and embed on phase 5's fp32 model and
   engine configuration: (a) an ``AdapterPool(4, 16, 12, 768)`` with
   three adapters from ``random_weights`` at ``LORA_SCALE`` serves phase
   5's 16 requests, 4 on the base model and 4 on each adapter, plainly
   and under ``NgramDrafter(k=4)``: base tokens equal phase 5's (bitwise
   without speculation), each adapter request's greedy tokens a
   pool-less engine's over the model merged to W + A@B (near-ties
   counted), at least half of them off the base model's, 2 argument
   signatures, a clean audit with no adapter reference left, exact
   launch counts; (b) phase 5's first 8 prompts under a regex,
   ``json_object``, a ``json_schema`` and an allow-list, greedy and
   sampled, plus a regex planted to dead-end: every token legal, every
   accepting finish matching its grammar, greedy tokens the masked
   argmax of a no-cache forward (near-ties counted), the dead end
   retired ``constraint_dead_end`` and counted, phase 5's trace on the
   same engine afterwards giving phase 5's greedy tokens, the greedy
   four again at k = 4; (c) 8 score and embed requests alone (no decode
   step, K4 0) and mixed with 8 generate requests (the same numbers
   bitwise), held to a full-sequence forward (``SCORE_TOL``,
   ``EMBED_TOL``), and ``/v1/score`` and ``/v1/embed`` through the
   ingest answering 200 with them; (d) a live adapter request and a
   live request under the allow-list migrated out mid-flight and
   restored on a second engine whose own pool holds the same adapter
   (``swap_in``): the adapter one gives the uninterrupted run's tokens
   (near-ties held to the merged model), every token of the constrained
   one is legal and its masked argmax, both audits are clean and no
   adapter reference is left; the phase's wall and decode step p50
   beside phase 5's printed (host clock);
5o. (after 5m) the small head dims: the paged engine serves
   ``gpt_tiny`` (4 heads of 16) and ``gpt_tiny8`` (8 heads of 8), fp32,
   8 greedy requests each on fp32 pools (every token the teacher-forced
   argmax but at near-ties) and on int8 pools (agreement >= 0.9), exact
   K4 and K5 launches;
5m. adaptive serving on phase 5's fp32 model: (a) a forced chunk budget
   (1 -> 2 -> 4, one step a window of 8 ticks) on phase 5's trace:
   greedy tokens phase 5's (near-ties counted), K5 launches phase 5's
   exactly (only the ticks they fall in move), K4 and K2 exact for the
   run's own steps, 2 counted decisions, 2 ``adapt`` flight events and no
   absorbed controller error; (b) ``AdaptiveSuite()`` at its defaults on
   the same trace: tokens as in (a), each controller's decisions, value
   and last signal, and the wall, TTFT p50 and decode step p50 beside
   phase 5's (host clock, not gated); (c) 5d's ``NgramDrafter(k=4)``
   trace at a forced ``k_eff`` of 2 and under a ``DraftLenController``:
   greedy tokens 5d's, K4 at L a verify step on the verify of k + 1 = 5
   rows, no recompile; (d) 5i's poisoned starved pool with a host tier
   under a ``SwapMinController``: greedy tokens 5i's, the swap meters
   above 0 and equal to the tier's spills plus swap-ins, the copy's
   seconds a block by CUDA events and by the host clock;
6. training: ``gpt2_small`` at full width and depth, batch 16 x 1024,
   ``AdamW`` and ``ShardedTrainer(amp=True)`` (the configuration of
   ``bench.py``), 2 warm-up and 10 timed steps: a finite, falling loss,
   exact launch counts per step, and an fp32 forward on the card equal
   to the same forward on the CPU; tokens/s, step p50 and MFU;
6b. the loop a user writes, in fp16: the same model and batch with
   ``recompute_granularity="full"``, ``auto_cast(dtype="float16")``,
   ``GradScaler`` and AdamW on a warm-up + cosine schedule with a
   global-norm clip, 2 + 10 steps: a finite, falling loss, launches K1
   = 2L, K3a = L and K2 = 4L + 1 a step (the fp16 K1 and K3 bodies;
   each block's forward runs again in the backward), every step's
   learning rate the schedule replayed on the host, and one planted
   step whose loss is multiplied by inf skipped (parameters and AdamW
   state bitwise unchanged, the scale halved, one skip); tokens/s, step
   p50 and peak memory beside phase 6's;
6c. the model's defaults: ``gpt2_small`` with its 0.1 dropouts, batch
   4 x 1024, ``decorate(level="O2", dtype="bfloat16")`` with AdamW's
   fp32 master weights, 5 steps of a user loop and then 5 through
   ``ShardedTrainer(recompute=True)``: a finite, falling loss, K1 = K3 =
   0 (attention dropout keeps the plain attention), K2 exact, bf16
   parameters beside fp32 masters (LayerNorm stays fp32);
6d. fault-tolerant training, ``gpt2_small`` at full width and depth:
   ``DistributedStrategy(gradient_merge=True, k_steps=4, avg=True)`` over
   4 micro-batches of 4 x 1024 with SGD in fp32 against one step on the
   16 x 1024 batch (every parameter within MERGE_TOL; K1 = K3a = L and
   K2 = 2L + 1 each micro-step), then 2 + 5 merged windows under AMP bf16
   AdamW (tokens/s and window p50 beside phase 6's); the anomaly policy
   through a float ``scale`` leaf of a 4 x 1024 batch that
   ``fault_injection.nan_batch`` poisons (``skip_step``: the step counted,
   parameters and AdamW state bitwise unchanged, a
   ``TransientFailureWarning``; ``raise``: ``FloatingPointError``;
   ``rollback`` after 2 bad steps to an async ``CheckpointManager`` save
   still committing: the saved state bitwise), a newer version with one
   flipped byte that ``restore`` falls back from, and ``save_checkpoint``
   loaded by a trainer from another seed bitwise (parameters, AdamW
   slots, step, scheduler) whose next 3 losses agree within RESUME_RTOL;
   the checkpoint's bytes, the async save's stall and commit, a blocking
   save, the sha256 verify and a restore, timed;
6e. ZeRO offload, phase 6's configuration under
   ``DistributedStrategy(sharding=True, sharding_configs={"offload":
   True})``: 12 steps (2 + 10) in lockstep with 12 without offload, both
   updates fed the same gradients (K3a's dQ atomics differ run to run):
   losses, parameters, every AdamW slot and the offloaded trainer's
   checkpoint (read back) bitwise equal to the plain trainer's, and
   every non-scalar slot pinned host memory after each step; then the
   offloaded trainer alone on its own gradients, 10 timed steps:
   tokens/s, step p50, peak memory, one profiled step and the slots'
   copy in and out on their own, beside phase 6's; exact K1, K3a and K2
   launches;
6f. the other optimizers, fleet and ASP: ``gpt2_small`` at 4 x 1024
   under AMP bf16 through ``ShardedTrainer`` for 3 steps each with
   Adagrad, Adamax, RMSProp (plain; centered with momentum), Lamb,
   Adadelta, ``fleet.distributed_optimizer`` over a Momentum with
   ``lars`` (a Lars inside), over AdamW with ``localsgd`` (k 2: one
   sync), and AdamW decorated by ASP after ``prune_model`` (every pruned
   weight 2:4 sparse after every step): finite losses and exact K1, K3a
   and K2 launches; each one's first update at ``gpt_tiny`` (4 heads of
   16) in fp32 on the card against the CPU within OPT_TOL in global
   norm;
7. encoders, at full width and depth with random weights from a seed
   and synthetic ids: (7a) ``BertForPretraining(BertConfig())``
   (BERT-base, 12 layers, hidden 768, vocab 30522) at dropout 0, batch
   32 x 512 with 15% of the positions masked and NSP labels, trained by
   ``ShardedTrainer(amp=True)`` with AdamW, 2 warm-up and 10 timed
   steps: a finite, falling loss, K1 = K3a = 12 and K2 = 26 a step (the
   non-causal flash route, LayerNorm at epsilon 1e-12); tokens/s, step
   p50, MFU, peak memory and one profiled step; (7b) one forward and
   backward of 7a's model with no mask (K1/K3a) against an all-ones
   padding mask (the plain attention), in fp32 and under bf16 AMP: the
   loss and every gradient within limits from FLASH_TOL (ROUTE_DTYPES);
   (7c) the model at its defaults (0.1 dropouts) on batches with 10-20%
   padding: K1 = K3a = 0, K2 = 26 a step, finite losses; (7d)
   ``ErnieForSequenceClassification(ernie_1_0())`` at dropout 0, batch
   32 x 128 with task-type ids, 2 + 10 fine-tuning steps (K1 = K3a = 12,
   K2 = 25 a step; tokens/s, step p50, MFU, peak memory), then
   ``eval_step`` and ``predict_step`` (K1 = 12, K2 = 25 a forward);
   (7e) ``nn.Transformer()`` at its defaults, dropout 0, batch 16 with
   source and target 256 and ``generate_square_subsequent_mask`` as
   ``tgt_mask``, one training step: K1 = K3a = 12 (the encoder's
   self-attention and the decoder's cross-attention; the masked decoder
   self-attention takes the plain route), K2 = 30;
6g. GPT-3 XL: ``GPTForCausalLM(gpt3_1p3b())`` at full width and depth
   (24 layers, hidden 2048, 16 heads of 128, vocab 50304), dropout 0,
   trained by ``ShardedTrainer`` with AdamW under AMP bf16 at 8 x 2048,
   2 warm-up and 5 timed steps, no recompute: the first loss finite and
   within 0.5 of ln 50304, a falling loss, K1 = K3a = 24 and K2 = 49 a
   step; tokens/s, step p50, MFU, peak memory, one profiled step and the
   fp32 head's device time alone;
5n. GPT-3 in bf16: (a) ``gpt3_1p3b`` serves phase 5c's 8 greedy
   requests on bf16 pools, then int8 pools (K4 and K5 at head dim 128);
   (b) ``gpt3_13b``, built on the card in bf16 once 6g's trainer and
   (a)'s model are freed, serves 4 of them on bf16 pools, its peak
   memory printed: exact launches, greedy agreement >= 0.9 each;
8a. GPT-MoE training, the repo's single-chip MoE workload
   (``benchmarks/baseline_suite.py:181-201``) uncut: a GPT-2-small
   backbone with 8 gshard top-2 experts in every other block, dropout 0,
   ``ShardedTrainer(loss_fn=model.loss_with_aux, amp=True)``, AdamW,
   8 x 1024, 2 warm-up and 10 timed steps: the first loss within 0.5 of
   ln 50304 and falling, K1 = K3a = 12 and K2 = 25 a step; tokens/s,
   step p50, MFU over the 152,847,408 active and the 322,854,960
   parameters, peak memory, the assignments a step drops, one profiled
   step and the step by piece (gate and plan, gather, expert bmms,
   combine, attention, head; each timed alone);
8b. ``gpt_moe_1p3b`` (7,357,853,888 parameters) built on the card in bf16
   at full width and depth serves 5c's 8 greedy requests on bf16 pools
   and on int8 pools, (i) at its eval capacity (the assignments dropped
   in decode and prefill, decode step p50; the agreement with the
   teacher-forced argmax printed: that forward's drops differ) and (ii)
   at capacity E / top_k, where nothing drops (each row's routing held
   to a teacher-forced forward's: every row routed to other experts a
   near-tie, p2 - p3 < MOE_FLIP_GAP, and agreement >= MOE_AGREE over the
   tokens whose position routes alike); (iii) upcast to fp32 at
   capacity E / top_k, every
   greedy token the teacher-forced argmax but at near-ties; exact
   launches in each, peak memory;
8c. ``gpt_moe_tiny`` holds its CPU result on the card: the paged
   engine's greedy tokens exactly at the default capacity and at factor
   0.5 (prefill drops), one fp32 training step each for the gshard,
   Switch and expert-choice gates and the combine route within 7b's
   FLASH_TOL bounds, and ``ClipGradForMOEByGlobalNorm``'s coefficient
   within 1e-6;
8d. a stack of 12 ``FusedTransformerEncoderLayer``s (768 wide, 12
   heads, 32 x 512), forward and backward of a seeded random projection
   of its output under bf16 AMP on the flash route (K1 = K3a = 12, K2 =
   24) and on an all-zero additive mask's plain route, each held to the
   stack in fp32: the flash route's distances (output, worst gradient,
   worst q/k/v gradient) within FUSED_RATIO times the plain route's
   (``fused_fault_check.py`` plants K1 and K3a faults against it);
8e. ``gpt2_small`` at full width and depth trained over meshes of ranks
   (global batch 8 x 1024, AdamW with a global-norm clip, 3 steps):
   (a) one rank on NCCL through ``fleet.init`` and
   ``ShardedTrainer(mesh=)``, bitwise the one-process run given the same
   gradients; (b) dp 2, (c) mp 2, (d) ZeRO-2 and ZeRO-3 over sharding 2
   and (e) dp 2 x mp 2, gangs of ranks on this card over gloo started by
   the port's launcher (``mesh_gang.py``), each in fp32 held to the
   one-process run (MESH_LOSS_RTOL, MESH_PARAM_ATOL), each rank's K1,
   K3a and K2 launches exact, and the bf16 AMP step printed (gloo through
   host, not a measure of NCCL); (e)'s checkpoint loaded into one
   process gives (e)'s next loss;
9. the ``kernels`` JSON line (K1's, K3a's and K2's launches include
   phases 6e, 6f, 6g, 7 and 8's, and every rank's of 8e; K2's, K4's and
   K5's 5m's, 5n's, 5o's and 8's), then the ``ok`` line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,      # fp32 on the CUDA cores
              "bfloat16": 989e12,    # bf16 on the tensor cores
              "float16": 989e12}     # fp16 on the tensor cores

# fp32: the kernels and the plain versions differ only in summation
# order (online softmax over blocks vs one softmax; warp-shuffle vs
# torch's reduction tree). bf16: the output is rounded to bf16 once, up
# to half an ulp (0.0156 below |y| = 8); the reference is the plain
# version evaluated in fp32 on the same bf16 values, because the bf16
# plain version itself rounds logits and P to bf16 at other places.
# fp16 (K2, K4, K5): the output rounded to fp16 once (2**-11
# relatively); over int8 pools the fp16 plain version also rounds the
# dequantized view and its logits to fp16, which reads up to 2.8e-3 of
# max(1, max |plain|) on an H100 (PERF.md): the limit sits 2.8x above.
ATOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 8e-3}

# fp16 (the flash kernels' third dtype, fp16 AMP's): the tensor-core
# bodies instantiated on __half, held to gates of their own. The cases of
# k1_case_inputs / k3_case_inputs run at unit scale, as in bf16, under
# "float16": fp16 keeps 3 more bits than bf16, so O and the gradients
# differ by roundings to fp16 (rtol) plus P and dS rounded to fp16 from
# logits that differ in the last fp32 bits (atol). The timed shapes run
# in fp16 with q and k scaled by FP16_QK_SCALE, so that the largest
# logits reach ~1e4 (fp16 itself tops out at 65504), under
# "float16-scaled": the logits are fp32 sums of terms ~1600 times larger,
# whose last bits move lse and, through P and dS, O and the gradients by
# as much more; dQ and dK carry K's and Q's scale of 40, and the
# long-context route's dK (delta from the route's own fp16 O, lse from
# its forward) moves most. Over those cases on an H100 the sound
# kernels' worst errors are, unit scale: lse 9.5e-7 (bf16's 1.9e-6:
# one lse limit for both), O 1.39e-4 + 2**-10 |plain|, dQ 2.07e-4, dK
# 1.68e-4, dV 1.75e-4 + 2**-9 |plain|; scaled: lse 4.9e-3, O 1.73e-3 +
# 1e-2 |plain|, dQ 0.0693, dK 0.0347 (the route), dV 1.79e-3 + 1e-2
# |plain|; the shared gate's 7.7e-4 and 9.6e-4 (k1_fault_check.py,
# k3_fault_check.py, PERF.md). Each limit sits 3.5-5.2x above its worst,
# and those scripts show each planted fault that changes an output
# failing the fp16 gates.
FP16_QK_SCALE = 40.0
FP16_SCALED = "float16-scaled"

# flash kernels, relative to max(1, max |plain|) of each output. fp32:
# summation order over up to 8320 keys or queries, and the fused dQ's
# fp32 atomics, whose order changes from run to run. bf16: one rounding
# of each output to bf16, plus P and dS, which both sides round to bf16
# at the same places but from logits that differ in the last fp32 bits.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 4e-3,
             FP16_SCALED: 4e-3}

# K1 is held to more than FLASH_TOL: lse on its own, absolutely, and O
# element by element, |O - plain| <= atol + rtol * |plain|. Under causal
# masking |O| falls from |v[0]| in row 0 to ~0.07 past row 500 (S 1000),
# so a limit relative to max |plain| lets a late row lose a whole key
# tile; these do not. bf16 O differs by one rounding of each side to
# bf16 (rtol) plus P rounded at another running max (atol); lse and fp32
# O differ in summation order only. Over every K1 case of this script on
# an H100 the sound kernel's worst errors are lse 1.9e-6 (both dtypes),
# bf16 O 1.06e-3 + 1e-2 |plain|, fp32 O 6.8e-7 + 1e-5 |plain|
# (k1_fault_check.py, PERF.md); the limits sit 3-5x above them, and that
# script shows each planted fault that changes an output failing them.
K1_TOL = {"float32": {"lse": 1e-5, "atol": 3e-6, "rtol": 1e-5},
          "bfloat16": {"lse": 1e-5, "atol": 3e-3, "rtol": 1e-2},
          "float16": {"lse": 1e-5, "atol": 5e-4, "rtol": 2.0 ** -10},
          FP16_SCALED: {"lse": 2e-2, "atol": 6e-3, "rtol": 1e-2}}

# The K3 kernels (K3a, K3b-dkv, K3b-dq) are held to more than FLASH_TOL
# too: each of dQ, dK and dV element by element, |out - plain| <= atol +
# rtol * |plain|, so a dropped query or key tile or a lost warp of dQ
# cannot hide under a limit relative to the largest gradient. bf16
# differs by one rounding of each side to bf16 (rtol) plus P and dS
# rounded to bf16 from logits that differ in the last fp32 bits (atol; dV
# sums P, the largest such term); fp32 differs in summation order, and
# K3a's dQ also in the order of its fp32 atomics, which changes from run
# to run (K3b-dq writes dQ once: its spread is 0). The limits sit 3-5x
# above the sound kernels' worst errors over every K3 case of this script
# on an H100, over several runs (k3_fault_check.py, PERF.md); K3b-dq's
# worst dQ (bf16 8.9e-4, fp32 2.0e-6) is K3a's, so one dQ limit holds
# both, at 4.5x and 4.0x.
K3_TOL = {"float32": {"rtol": 1e-5,
                      "atol": {"dQ": 8e-6, "dK": 5e-6, "dV": 4e-6}},
          "bfloat16": {"rtol": 1e-2,
                       "atol": {"dQ": 4e-3, "dK": 4e-3, "dV": 1.5e-2}},
          "float16": {"rtol": 2.0 ** -9,
                      "atol": {"dQ": 8e-4, "dK": 7e-4, "dV": 7e-4}},
          FP16_SCALED: {"rtol": 1e-2,
                        "atol": {"dQ": 0.25, "dK": 0.12, "dV": 6.5e-3}}}


# K4's and K5's tensor-core bodies instantiated on fp16 (q fp16; fp16
# pools, or int8 codes with their scales) are held to gates of their
# own, keyed "fp16" and "int8-fp16" in K4_TOL and K5_TOL, the same way:
# one rounding of the output to fp16 (rtol 2**-9, four half-units of
# fp16's last place), and P rounded to fp16 before P.V (atol), against
# the plain version in fp32 on clean, poisoned and NaN-poisoned pools.
# Over every K4 and K5 case of this script run in fp16 (phase 3 runs
# FP16_CASES; k4_ and k5_fault_check.py run them all) on an H100 the
# sound bodies' worst errors at that rtol are, fp16 pools: K4 2.27e-4, K5
# 2.00e-4; int8 pools: K4 4.82e-4, K5 7.55e-4 (k4_fault_check.py,
# k5_fault_check.py, PERF.md): the limits sit 4.4x, 5.0x, 4.1x and 4.0x
# above them, and those scripts show each planted fault that changes an
# fp16 output failing them.

# K5's bf16 body (q bf16; bf16 pools, or int8 codes with their scales)
# is held to more than ATOL too: element by element, |out - plain| <=
# atol + rtol |plain|, against the plain version evaluated in fp32 on the
# same values (int8 codes dequantized in fp32, as the kernel folds the
# scales), on clean, poisoned and NaN-poisoned pools. The two differ by
# one rounding of the output to bf16 (rtol) and by P rounded before P.V
# (atol): to bf16 over bf16 pools, to fp16 over int8 pools, whose values
# reach the blocks' absmax. Over every K5 case of this script on an
# H100 the sound body's worst errors are 1.88e-3 + 1e-2 |plain| over
# bf16 pools and 6.0e-4 + 1e-2 |plain| over int8 pools
# (k5_fault_check.py, PERF.md); the limits sit 3.2x and 3.3x above them,
# and that script shows each planted fault that changes an output
# failing them.
K5_TOL = {"bf16": {"atol": 6e-3, "rtol": 1e-2},
          "int8": {"atol": 2e-3, "rtol": 1e-2},
          "fp16": {"atol": 1e-3, "rtol": 2.0 ** -9},
          "int8-fp16": {"atol": 3e-3, "rtol": 2.0 ** -9}}

# K4's bf16 body (q bf16; bf16 pools, or int8 codes with their scales;
# the key walk split across a cluster) is held to its own gate the same
# way, against the fp32 plain version on clean, poisoned and
# NaN-poisoned pools: one rounding of the output to bf16 (rtol), and P
# rounded to bf16 (fp16 over int8 pools) before P.V (atol). The splits'
# and warps' partials are merged in fp32. Over every bf16 K4 case of
# this script on an H100 the sound body's worst errors are 1.96e-3 +
# 1e-2 |plain| over bf16 pools and 4.13e-4 + 1e-2 |plain| over int8
# pools (k4_fault_check.py, PERF.md); the limits sit 3.1x and 3.6x above
# them, and that script shows each planted fault that changes an output
# failing them.
K4_TOL = {"bf16": {"atol": 6e-3, "rtol": 1e-2},
          "int8": {"atol": 1.5e-3, "rtol": 1e-2},
          "fp16": {"atol": 1e-3, "rtol": 2.0 ** -9},
          "int8-fp16": {"atol": 2e-3, "rtol": 2.0 ** -9}}

# K2 is held to the shared gate against its plain version in fp32
# (layer_norm_ref): y within ATOL, mean and rstd within 2e-5. At a large
# mean (1e3 + 2 randn) the plain version in fp32 is itself off, since it
# rounds its mean once more, which moves every y by up to ~1e-4; there
# ATOL holds y against the plain formula evaluated in fp64. On top of it
# K2 is held to its own gate, element by element, |out - exact| <= atol
# + rtol |exact|, for y (in x's dtype), mean and rstd (fp32), against
# the plain formula in fp64, in every case. fp32 y differs by a few
# fp32 roundings and rsqrtf's error (rtol), bf16 y by its one rounding to
# bf16 (rtol 2**-8); the mean by one fp32 rounding of a value up to 1e3
# (rtol), rstd by rsqrtf's. Over the K2 cases of this script at C <= 771
# on an H100 the sound kernels' worst errors are fp32 y 7.5e-8 + 1e-6
# |exact|, bf16 y 5.7e-8 + 2**-8 |exact| (half a bf16 ulp), mean 9.2e-8
# + 1.2e-7 |exact|, rstd 3.4e-8 + 1e-7 |exact| (k2_fault_check.py,
# PERF.md): the limits sit 3-4x above them. The wide bf16 rows (C 2048,
# 65536) reach 0.43 and 0.52 of the limits, their means' fp32 sums
# erring by up to 1.5e-7 + 1.2e-7 |exact|. k2_fault_check.py shows each
# planted fault that changes an output failing them. fp16 y (K2's
# __half instantiation) differs by its one rounding to fp16 (2**-11
# relatively, half a unit) plus the fp32 mean's error times rstd, which
# dominates near y = 0: over the same cases in fp16 (k2_fault_check.py
# runs them all; phase 3 FP16_CASES) its worst is 2.0e-7 + 2**-11
# |exact| at C 65536 and 1.05e-7 + 2**-11 |exact| at C <= 16384
# (k2_fault_check.py, PERF.md); the limit, 6e-7 + 2**-9 |exact|, sits 3x
# above in atol and 4x in rtol.
K2_TOL = {"float32": {"atol": 3e-7, "rtol": 4e-6},
          "bfloat16": {"atol": 2e-7, "rtol": 1.2e-2},
          "float16": {"atol": 6e-7, "rtol": 2.0 ** -9},
          "mean": {"atol": 4e-7, "rtol": 4.8e-7},
          "rstd": {"atol": 1.4e-7, "rtol": 4e-7}}

# The fp32 paged body (K4 and K5 with fp32 q, over fp32 pools or int8
# codes with their scales; its key walk split across a cluster) is held
# to its own gate on top of ATOL, element by element against the fp32
# plain version on clean, poisoned and NaN-poisoned pools: the two differ
# in summation order only (the online softmax over split key tiles, exp2
# of log2-scaled logits, the merge in fp32). Over every fp32 K4 and K5
# case of this script on an H100 the sound body's worst errors are 4.9e-7
# + 1e-5 |plain| over fp32 pools and 5.4e-6 + 1e-5 |plain| over int8
# pools, whose values reach the blocks' absmax (k45_f32_fault_check.py,
# PERF.md); the limits sit 3.7-4x above them, and that script shows each
# planted fault that changes an output failing them.
F32_PAGED_TOL = {"fp32": {"atol": 2e-6, "rtol": 4e-5},
                 "int8": {"atol": 2e-5, "rtol": 4e-5}}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------- timing
class Timer:
    """Median device time of single launches, from CUDA events recorded
    around each one. All launches of a measurement are enqueued behind a
    spin kernel, so the host's own overhead never shows as device time;
    a 64 MB write between launches evicts the 50 MB L2, so every launch
    finds its inputs cold, as one layer's pools are in a real step. A
    call that launches many kernels gets fewer calls per measurement:
    a stream holds ~1024 pending launches, and past that the host
    blocks in the launch until the device drains the queue. Each
    measurement starts from the shortest spin and lengthens it only for
    itself, so the retries of a call with many launches do not add up
    over a run of measurements."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        self.cycles = 20_000_000

    def __call__(self, fn, n: int = 50) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        cycles = self.cycles
        while True:
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(n)]
            torch.cuda._sleep(cycles)
            for start, end in ev:
                self.flush.zero_()
                start.record()
                fn()
                end.record()
            # the device had not reached the last launch when the host
            # finished enqueueing: it never waited for the host
            ahead = not ev[-1][0].query()
            torch.cuda.synchronize()
            if ahead:
                return float(np.median([s.elapsed_time(e) for s, e in ev]))
            cycles *= 4
            n = max(10, n // 2)
            check(cycles < 8_000_000_000,
                  f"could not enqueue {n} calls ahead of the device")


# --------------------------------------------------------------- phases
def card_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    cap = torch.cuda.get_device_capability(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} | capability {cap}", flush=True)
    check(cap == (9, 0), f"compute capability {cap}: the kernels are "
          "built for sm_90a (Hopper)")
    return card


def build_phase():
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    how = "compiled" if _build.build_seconds is not None else "cached"
    print(f"build: {secs:.2f} s ({how}) from "
          f"{', '.join(p.name for p in _build.sources())} into "
          f"{_build.build_dir()}", flush=True)


_PTXAS_F32 = re.compile(r"paged_f32_kernelI(f|a)Li(\d+)ELi(\d+)E")
_PTXAS_K5 = re.compile(r"chunk_prefill_mma_kernelILi(\d+)E"
                       r"(13__nv_bfloat16|6__half)(a|S\d*_)E")
_PTXAS_K4 = re.compile(r"paged_decode_mma_kernelILi(\d+)E"
                       r"(13__nv_bfloat16|6__half)(a|S\d*_)E")
_PTXAS_FLASH = re.compile(r"flash_fwd_(mma_)?kernelILi(\d+)E"
                          r"(13__nv_bfloat16|6__half)?")
_PTXAS_BWD = re.compile(r"flash_(bwd_mma|dq_mma|dkv|dq)_kernelILi(\d+)E"
                        r"(?:Lb(\d)E)?(13__nv_bfloat16|6__half)?")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def _occupancy(fn, *args) -> str:
    """A tensor-core body's shared memory and the CTAs of it an SM holds
    (for K4's cluster body: the clusters the card holds at once), as the
    CUDA runtime computes them for the built kernel, through the
    occupancy entry point ``fn`` (``ptt_flash_fwd_occupancy``,
    ``ptt_paged_decode_occupancy``, ...)."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build

    ctas, smem = ctypes.c_int(), ctypes.c_int()
    err = getattr(_build.load_library(), fn)(*args, ctypes.byref(ctas),
                                             ctypes.byref(smem))
    check(err == 0, f"{fn}{args} failed (cudaError {err})")
    unit = ("clusters on the card" if fn == "ptt_paged_decode_occupancy"
            else "CTAs per SM")
    return (f", {smem.value} bytes shared memory, {ctas.value} {unit} "
            "(CUDA runtime)")


def _ptxas_label(src: str, name):
    """What a matched kernel name is, whether it is a tensor-core body
    that must not spill, and its occupancy query's (function, args): the
    occupancy entry points report the bf16 instantiations, so an fp16 one
    has none."""
    if src == "flash_fwd.cu":
        mma = name.group(1) is not None
        D, half = int(name.group(2)), name.group(3) == "6__half"
        if not mma:
            return f"K1 fp32 CUDA cores, D {D}", False, None
        return (f"K1 {'fp16' if half else 'bf16'} mma.sync, D {D}", True,
                None if half else ("ptt_flash_fwd_occupancy", D))
    if src == "flash_bwd.cu":
        kind, D = name.group(1), int(name.group(2))
        fused = name.group(3) == "1"
        half = name.group(4) == "6__half"
        dt = "fp16" if half else "bf16"
        if kind == "dq":
            return f"K3b-dq fp32 CUDA cores, D {D}", False, None
        if kind == "dq_mma":
            return (f"K3b-dq {dt} mma.sync, D {D}", True,
                    None if half else ("ptt_flash_bwd_dq_occupancy", D))
        what = "K3a" if fused else "K3b-dkv"
        if kind == "dkv":
            return f"{what} fp32 CUDA cores, D {D}", False, None
        return (f"{what} {dt} mma.sync, D {D}", True,
                None if half else ("ptt_flash_bwd_occupancy", D,
                                   int(fused)))
    if name.re in (_PTXAS_K4, _PTXAS_K5):
        D, int8 = int(name.group(1)), name.group(3) == "a"
        dt = "fp16" if name.group(2) == "6__half" else "bf16"
        k4 = name.re is _PTXAS_K4
        occ = ("ptt_paged_decode_occupancy" if k4 else
               "ptt_chunk_prefill_occupancy", D, 2 if int8 else 1)
        return (f"{'K4' if k4 else 'K5'} {dt} mma.sync, "
                f"{'clusters, ' if k4 else ''}pool "
                f"{'int8' if int8 else dt}, D {D}", True,
                None if dt == "fp16" else occ)
    return (f"K4/K5 fp32 body, pool {'int8' if name.group(1) == 'a' else 'fp32'}"
            f", D {name.group(2)}, {name.group(3)}-row tiles", False, None)


def _sass_ops(obj: str, ops=("HMMA", "RED", "ATOM")):
    """Per kernel of an object file, how many SASS instructions of each
    family of ``ops`` ``cuobjdump -sass`` lists (HMMA: tensor-core
    products; RED, ATOM and their global forms REDG, ATOMG: the fused
    dQ's atomics)."""
    import shutil
    from pathlib import Path

    from paddle_tpu_torch.ops.kernels import _build

    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    out = subprocess.run([tool, "-sass", obj], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {obj}: {out.stderr}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            m = re.search(r"\s(" + "|".join(ops) + r")G?[.\s]", line)
            if m:
                counts[fn][m.group(1)] += 1
    return counts


def ptxas_phase():
    """Registers and spills of every K1, K3, K4 and K5 instantiation, from
    ``nvcc -Xptxas -v`` on their sources; a tensor-core body (K1, K3a,
    K3b-dkv, K3b-dq, K4 and K5 in bf16 and fp16) or an
    instantiation of the fp32 paged body that spills fails the run. For
    the bf16 tensor-core bodies also their shared memory and the CTAs an
    SM holds (K4: the clusters the card holds), and for every
    tensor-core body the tensor-core products (HMMA) and atomics in its
    SASS: a body without HMMA, a K3a without atomics, or a K3b-dq with
    any, fails; so does an fp32 paged body with any HMMA (fp32 stays on
    the CUDA cores)."""
    import tempfile

    from paddle_tpu_torch.ops.kernels import _build

    pats = {"paged_attention.cu": (_PTXAS_K4, _PTXAS_F32),
            "chunk_prefill.cu": (_PTXAS_K5, _PTXAS_F32),
            "flash_fwd.cu": (_PTXAS_FLASH,), "flash_bwd.cu": (_PTXAS_BWD,)}
    srcs = [p for p in _build.sources() if p.name in pats]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(src), "-o", f"{tmp}/{src.stem}.o"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in srcs]
        outs = [p.communicate(timeout=600)[0] for p in procs]
        check(all(p.returncode == 0 for p in procs),
              "nvcc -Xptxas -v failed:\n" + "\n".join(
                  o for p, o in zip(procs, outs) if p.returncode))
        sass = {**_sass_ops(f"{tmp}/flash_fwd.o"),
                **_sass_ops(f"{tmp}/flash_bwd.o"),
                **_sass_ops(f"{tmp}/chunk_prefill.o"),
                **_sass_ops(f"{tmp}/paged_attention.o")}
    seen = {"K1": 0, "K3": 0, "K4": 0, "K5": 0, "F32": 0}
    for src, out in zip(srcs, outs):
        name = spill = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                name = next((m for m in (p.search(line)
                                         for p in pats[src.name]) if m),
                            None)
                full = line.split("'")[1] if "'" in line else ""
            elif name is not None and "spill" in line:
                spill = _SPILL.search(line)
            elif name is not None and "Used" in line:
                label, mma, occ = _ptxas_label(src.name, name)
                regs = int(line.split("Used", 1)[1].split()[0])
                stores, loads = int(spill.group(1)), int(spill.group(2))
                extra = ""
                if name.re is _PTXAS_F32:
                    # fp32 on the CUDA cores: no TF32 or bf16 products
                    ops = sass.get(full)
                    seen["F32"] += 1
                    check(stores == loads == 0, f"ptxas: {label} spills "
                          f"{stores} bytes stored, {loads} loaded")
                    check(ops is not None and ops["HMMA"] == 0,
                          f"SASS: {label} has tensor-core products ({ops})")
                    extra = f", SASS {ops['HMMA']} HMMA"
                if mma:
                    seen[label[:2]] += 1
                    if occ is not None:
                        extra = _occupancy(*occ)
                    check(stores == loads == 0, f"ptxas: {label} spills "
                          f"{stores} bytes stored, {loads} loaded")
                if mma:
                    ops = sass.get(full)
                    check(ops is not None and ops["HMMA"] > 0,
                          f"SASS: {label} has no HMMA ({ops})")
                    check(not label.startswith("K3a")
                          or ops["RED"] + ops["ATOM"] > 0,
                          f"SASS: {label} has no atomics for dQ ({ops})")
                    check(not label.startswith("K3b-dq")
                          or ops["RED"] + ops["ATOM"] == 0,
                          f"SASS: {label} has atomics, but writes dQ "
                          f"once ({ops})")
                    extra += (f", SASS {ops['HMMA']} HMMA, {ops['RED']} "
                              f"RED, {ops['ATOM']} ATOM")
                print(f"ptxas {src.name}: {label}: {regs} registers, "
                      f"{stores} bytes spill stores, {loads} bytes spill "
                      f"loads{extra}", flush=True)
                name = None
    check(seen == {"K1": 4, "K3": 12, "K4": 8, "K5": 8, "F32": 24},
          f"ptxas: bodies seen {seen}, expected the tensor-core K1, K3a, "
          "K3b-dkv and K3b-dq in bf16 and fp16 at D 64 and 128, K4 and K5 "
          "in bf16 and fp16 over pools of q's type and int8 pools at both, "
          "and the fp32 body over fp32 "
          "and int8 pools at both in 16-, 32- and 64-row tiles, in K4's "
          "source and K5's")


def _bound(nbytes: float, flops: float, dtype: str):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def _record(rows, name, dtype, shape, err, timer, kernel, plain, library,
            nbytes, flops, **extra):
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    row = {"kernel": name, "dtype": dtype, "shape": shape,
           "max_abs_err": err, "kernel_ms": timer(kernel),
           "plain_ms": timer(plain),
           "library_ms": timer(library), "bound_ms": bound_ms,
           "bound_by": bound_by, **extra}
    rows.append(row)
    print("  " + json.dumps(row), flush=True)


# K2's cases: the timed shapes (R, C), serving's decode step and chunk
# (8 and 128 rows) and training's 16 x 1024 rows, in both dtypes; then
# rows of large mean (1e3 + 2 randn, fp32 only: bf16 keeps 8 bits of
# 1e3), where E[x^2] - mean^2 would lose ~1% of the variance; an odd C
# (771: no whole 16-byte vectors) and an offset view (x one element past
# an aligned base), which take the row kernel; and the wide rows of
# K2_WIDE: C 2048 (bf16: the warp kernel at its cap of 8 vectors a
# lane; fp32: the row kernel staged by 16-byte vectors), 16384 (staged
# past 48 KB of shared memory) and 65536 (fp32: past what one CTA's
# shared memory holds, read from global memory on each pass)
K2_TIMED = ((8, 768), (128, 768), (16384, 768))
# the fp16 cases of phase 3, by the kernels' shape labels: the serving
# path's shapes (K2 the decode step and training's rows; K4 the decode
# step, a verify of 4 and of 16 drafts; K5 a first chunk and the deepest
# prefix), over both pools; k2_, k4_ and k5_fault_check.py run every case
# in fp16
FP16_CASES = {"K2": ([8, 768], [16384, 768]),
              "K4": ([8, 1, 12, 64, 16, 64], [8, 5, 12, 64, 16, 64],
                     [8, 17, 12, 64, 16, 64]),
              "K5": ([128, 0, 12, 64, 16, 64], [128, 517, 12, 64, 16, 64])}
K2_WIDE = ((64, 2048), (16, 16384), (4, 65536))
# K2 at the shapes and epsilons phase 7 gives it, fp32 (LayerNorm is on
# AMP's black list): BERT's 32 x 512 and ERNIE's 32 x 128 rows of 768 at
# epsilon 1e-12, and nn.Transformer's 16 x 256 rows of 512 at 1e-5,
# which take the warp kernel at 4 vectors a lane (no other case does)
K2_PATH = (("7a", 16384, 768, 1e-12), ("7d", 4096, 768, 1e-12),
           ("7e", 4096, 512, 1e-5))


def k2_case_inputs(torch, dtype):
    """Every K2 case at ``dtype``: dicts of x, w, b, the shape label and
    whether it is timed."""
    g = torch.Generator(device="cuda").manual_seed(11)

    def affine(C):
        w = 1 + 0.1 * torch.randn(C, device="cuda", generator=g)
        b = 0.1 * torch.randn(C, device="cuda", generator=g)
        return w.to(dtype), b.to(dtype)

    for R, C in K2_TIMED:
        x = (torch.randn(R, C, device="cuda", generator=g) * 2 + 0.5)
        yield dict(x=x.to(dtype), wb=affine(C), shape=[R, C], timed=True)
    if dtype == torch.float32:
        x = torch.randn(128, 768, device="cuda", generator=g) * 2 + 1e3
        yield dict(x=x, wb=affine(768), shape=["large mean", 128, 768],
                   timed=False, plain_sound=False)
    x = torch.randn(64, 771, device="cuda", generator=g) * 2 + 0.5
    yield dict(x=x.to(dtype), wb=affine(771), shape=["odd C", 64, 771],
               timed=False)
    buf = torch.randn(64 * 768 + 8, device="cuda", generator=g) * 2 + 0.5
    x = buf.to(dtype)[1:64 * 768 + 1].view(64, 768)
    yield dict(x=x, wb=affine(768), shape=["offset view", 64, 768],
               timed=False)
    for R, C in K2_WIDE:
        x = torch.randn(R, C, device="cuda", generator=g) * 2 + 0.5
        yield dict(x=x.to(dtype), wb=affine(C), shape=["wide", R, C],
                   timed=False)
    if dtype == torch.float32:
        for tag, R, C, eps in K2_PATH:
            x = torch.randn(R, C, device="cuda", generator=g) * 2 + 0.5
            yield dict(x=x, wb=affine(C), shape=[tag, R, C, eps],
                       timed=False, eps=eps)


def _ln_exact(torch, x, w, b, eps):
    """The plain version's formula (layer_norm_ref's) in fp64: y, mean,
    rstd."""
    xd = x.double()
    mean = xd.mean(dim=-1, keepdim=True)
    xc = xd - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    y = xc * rstd
    if w is not None:
        y = y * w.double()
    if b is not None:
        y = y + b.double()
    return y, mean, rstd


def k2_run(torch, case):
    """K2 on one case with w and b, w only, b only and neither: the
    kernel's (y, mean, rstd), the plain version's on x, w and b in fp32,
    and the exact ones of each. Before each launch a NaN tensor of y's
    size is freed, so that an output row the kernel leaves unwritten
    reads NaN, not an earlier call's values."""
    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    x, (w, b) = case["x"], case["wb"]
    eps = case.get("eps", 1e-5)
    f32 = (lambda t: None if t is None else t.float())
    outs, plain, exact = [], [], []
    for wi, bi in ((w, b), (w, None), (None, b), (None, None)):
        torch.full_like(x, float("nan"))
        outs.append(k2.layer_norm_fwd(x, wi, bi, eps))
        plain.append(k2.layer_norm_ref(f32(x), f32(wi), f32(bi), eps))
        exact.append(_ln_exact(torch, x, wi, bi, eps))
    torch.cuda.synchronize()
    return outs, plain, exact


def k2_errors(dn, case, outs, plain, exact):
    """K2's measures: for the shared gate, the largest |y - plain| (ATOL;
    against the exact y where the fp32 plain version is not sound, as at
    a large mean) and the largest |mean - plain| and |rstd - plain|
    (2e-5; 0 where the plain version is not sound); and K2's own, the
    largest |out - exact| / (atol + rtol |exact|) of any element of y,
    mean or rstd against ``K2_TOL`` (NaN if any is not finite)."""
    sound = case.get("plain_sound", True)
    err, stat_err, share = 0.0, 0.0, 0.0
    for out, pl, ref in zip(outs, plain, exact):
        if sound:
            err = max(err, _err(out[0], pl[0]))
            stat_err = max(stat_err, _err(out[1], pl[1]),
                           _err(out[2], pl[2]))
        else:
            err = max(err, float((out[0].double() - ref[0]).abs().max()))
        for tol, a, r in ((K2_TOL[dn], out[0], ref[0]),
                          (K2_TOL["mean"], out[1], ref[1]),
                          (K2_TOL["rstd"], out[2], ref[2])):
            ratio = (a.double() - r).abs() / (tol["atol"]
                                              + tol["rtol"] * r.abs())
            if not _finite(ratio):
                return float("nan"), float("nan"), float("nan")
            share = max(share, float(ratio.max()))
    return err, stat_err, share


def layer_norm_phase(torch, timer, rows):
    """K2 on every case, fp32, bf16 and fp16, with and without w and b:
    ATOL on y and 2e-5 on mean and rstd against the plain version, K2_TOL
    on y, mean and rstd; the timed shapes beside the plain version and
    F.layer_norm (in x's dtype)."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dn = str(dtype).split(".")[1]
        for case in k2_case_inputs(torch, dtype):
            shape = case["shape"]
            if dn == "float16" and shape not in FP16_CASES["K2"]:
                continue
            err, stat_err, share = k2_errors(dn, case, *k2_run(torch, case))
            check(err <= ATOL[dn], f"K2 {dn} {shape}: max |y - plain| {err} "
                  f"> {ATOL[dn]}")
            check(stat_err <= 2e-5, f"K2 {dn} {shape}: mean/rstd disagree "
                  f"with the plain version by {stat_err}")
            check(share <= 1.0, f"K2 {dn} {shape}: an element of y, mean or "
                  f"rstd is off by {share} x its K2_TOL limit")
            if not case["timed"]:
                print(f"  K2 {dn} {shape}: max |y - plain| {err:.3g}, at "
                      f"{share:.3g} of K2_TOL", flush=True)
                continue
            x, (w, b) = case["x"], case["wb"]
            R, C = x.shape
            sz = x.element_size()
            _record(rows, "K2", dn, [R, C], err, timer,
                    lambda: k2.layer_norm_fwd(x, w, b, 1e-5),
                    lambda: k2.layer_norm_ref(x, w, b, 1e-5),
                    lambda: TF.layer_norm(x, (C,), w, b, 1e-5),
                    nbytes=R * C * 2 * sz + 2 * C * sz + 8 * R,
                    flops=8 * R * C, k2_limit_share=share,
                    k2_tol=K2_TOL[dn])


def _pool_case(torch, rs, nslots, bp, bs, H, D, dtype, spare=16):
    """Random pools and a table of distinct blocks (block 0, the scratch
    sink, and ``spare`` blocks are named by no table row)."""
    nblk = 1 + nslots * bp + spare
    table = (1 + rs.permutation(nblk - 1)[:nslots * bp]).reshape(
        nslots, bp).astype(np.int32)
    kp = torch.from_numpy(rs.randn(nblk, bs, H, D).astype(np.float32))
    vp = torch.from_numpy(rs.randn(nblk, bs, H, D).astype(np.float32))
    return (kp.to("cuda", dtype), vp.to("cuda", dtype),
            torch.from_numpy(table).cuda(), table)


def _poison(torch, kp, vp, table, reach, dead=1e9):
    """``dead`` in every pool row no (slot, table entry) can read under
    the mask ``col <= reach[slot]``; NaN in every block no table row
    names. For the plain version ``dead`` is 1e9, not NaN: it gathers
    whole table rows and multiplies their masked rows by p = 0. fp16
    pools take 3e4 for 1e9, which fp16 cannot hold (0 x inf is NaN)."""
    if kp.dtype == torch.float16 and dead == 1e9:
        dead = 3e4
    nblk, bs = kp.shape[0], kp.shape[1]
    readable = np.zeros((nblk, bs), bool)
    named = np.zeros((nblk,), bool)
    cols = np.arange(table.shape[1] * bs)
    for o in range(table.shape[0]):
        named[table[o]] = True
        ok = cols <= reach[o]
        readable[table[o][cols[ok] // bs], cols[ok] % bs] = True
    kp, vp = kp.clone(), vp.clone()
    rows_dead = torch.from_numpy(~readable).cuda()
    unnamed = torch.from_numpy(~named).cuda()
    for p in (kp, vp):
        p[rows_dead] = dead
        p[unnamed] = float("nan")
    return kp, vp


def _dense_view(torch, kp, vp, table_t, nrows):
    """Gathered (b, H, nrows, D) K and V for the library yardstick."""
    bs = kp.shape[1]
    nb = (nrows + bs - 1) // bs
    idx = table_t[:, :nb].long()
    b = table_t.shape[0]
    k = kp[idx].reshape(b, nb * bs, *kp.shape[2:])[:, :nrows]
    v = vp[idx].reshape(b, nb * bs, *vp.shape[2:])[:, :nrows]
    return (k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())


def _sdpa_yardstick(torch, q, kp, vp, table_t, table, t, reach):
    """The library call of a K4/K5 row: SDPA over the slots' dense view,
    gathered from full-precision pools beforehand (the gather not timed),
    masked col <= t + i."""
    import torch.nn.functional as TF

    s = q.shape[1]
    nrows = min(int(max(reach)) + 1, table.shape[1] * kp.shape[1])
    kd, vd = _dense_view(torch, kp, vp, table_t, nrows)
    qd = q.transpose(1, 2).contiguous()
    tt = torch.as_tensor(t, device="cuda").reshape(-1, 1, 1, 1)
    mask = (torch.arange(nrows, device="cuda")[None, None, None, :]
            <= tt + torch.arange(s, device="cuda")[None, None, :, None])
    return lambda: TF.scaled_dot_product_attention(qd, kd, vd,
                                                   attn_mask=mask)


def _pool_case_q(torch, rs, nslots, bp, bs, H, D, spare=16):
    """int8 pools of random codes with (block, head) scales of a
    quantized commit's size (absmax / 127 of unit-normal rows), and a
    table of distinct blocks as :func:`_pool_case` draws it."""
    nblk = 1 + nslots * bp + spare
    table = (1 + rs.permutation(nblk - 1)[:nslots * bp]).reshape(
        nslots, bp).astype(np.int32)
    codes = [torch.from_numpy(rs.randint(-127, 128, (nblk, bs, H, D)).astype(
        np.int8)).cuda() for _ in range(2)]
    scales = [torch.from_numpy((0.02 + 0.01 * np.abs(rs.randn(nblk, H))
                                ).astype(np.float32)).cuda()
              for _ in range(2)]
    return codes, scales, torch.from_numpy(table).cuda(), table


def _poison_q(torch, codes, scales, table, reach, dead_scale=1e7):
    """Saturated codes (127) in every pool row no (slot, table entry) can
    read under ``col <= reach[slot]``; ``dead_scale`` in every scale row
    of a block no table names (NaN only for the kernel alone: the plain
    version gathers named blocks only, but a block no table names is
    never read by either)."""
    nblk, bs = codes[0].shape[0], codes[0].shape[1]
    readable = np.zeros((nblk, bs), bool)
    named = np.zeros((nblk,), bool)
    cols = np.arange(table.shape[1] * bs)
    for o in range(table.shape[0]):
        named[table[o]] = True
        ok = cols <= reach[o]
        readable[table[o][cols[ok] // bs], cols[ok] % bs] = True
    rows_dead = torch.from_numpy(~readable).cuda()
    unnamed = torch.from_numpy(~named).cuda()
    codes = [c.clone() for c in codes]
    scales = [x.clone() for x in scales]
    for c, x in zip(codes, scales):
        c[rows_dead] = 127
        x[unnamed] = dead_scale
    return codes, scales


def _q_bytes(H, D, bs, rows_read, blocks_read, q_rows, sz, table_nbytes):
    """Bytes an int8 case must move: the codes of the rows it reads (1
    byte an element, K and V), one fp32 scale per (block, head) read,
    q in and out at q's size, the table."""
    return (rows_read * H * D * 2 + blocks_read * H * 4 * 2
            + 2 * q_rows * H * D * sz + table_nbytes)


def _paged_cost(H, D, bs, bp, t_np, s, sz, int8, index_nbytes):
    """Bytes and operations a K4/K5 case must move and do: each slot's
    rows up to its last query's position that the table holds, read once
    (K and V; int8 codes with a scale a block), q in and out at its size
    ``sz``, the table and offsets (``index_nbytes``); 4 flops a query
    row, key and element."""
    b = len(t_np)
    keys = np.minimum(t_np + s, bp * bs)         # rows the table can hold
    if int8:
        nbytes = _q_bytes(H, D, bs, int(keys.sum()),
                          int(((keys - 1) // bs + 1).sum()), b * s, sz,
                          index_nbytes)
    else:
        nbytes = (int(keys.sum()) * H * D * 2 * sz + 2 * b * s * H * D * sz
                  + index_nbytes)
    flops = 4 * H * D * sum(min(st + i + 1, k) for st, k in zip(t_np, keys)
                            for i in range(s))
    return nbytes, flops


# K4's cases (b, s, offsets, bp, bs) at gpt2_small's heads: the serving
# decode step (8 slots at shuffled offsets 0-1000, the headline row); a
# lone request at t 1000 (12 CTAs a head-walk without the cluster split,
# 16 key tiles); a speculative verify of 4 drafts (s 5) at the decode
# step's offsets; a slot whose reach runs off a table of 5 blocks (80
# rows, no multiple of a 64-key tile); and a verify of 15 drafts (s 16)
# off a table of 3 blocks of 11 rows (33 rows, one past a warp's 16
# keys), whose last warp slice holds one key and 15 zero-filled ones
# that rows 1-15's positions would admit (with 16-row blocks the table's
# end is always a slice's, and the reach mask has nothing to mask);
# verifies of 16 and 31 drafts (s 17 and 32) at the decode step's
# offsets, two 16-row tiles of the bf16 body (the second of one row at s
# 17) and one 32-row tile of the fp32 body, the slots near t 1000
# reaching past the table's 1024 rows; and 80 rows on 2 slots (5 tiles
# of the bf16 body, a 64-row and a ragged 16-row tile of the fp32 one).
K4_CASES = ((8, 1, None, 64, 16), (1, 1, (1000,), 64, 16),
            (8, 5, None, 64, 16), (2, 5, (78, 30), 5, 16),
            (1, 16, (32,), 3, 11), (8, 17, None, 64, 16),
            (8, 32, None, 64, 16), (2, 80, (3, 940), 64, 16))
K4_GEOMETRY = (12, 64)                  # H, D: gpt2_small's
# the other head dims the kernels take (8 to 128 in steps of 8, each body
# at a padded head dim of 64 or 128 with the columns past the real one
# zero-filled): gpt3_1p3b's and gpt3_13b's 128 at gpt3_1p3b's 16 heads,
# gpt_tiny's 16 (4 heads), gpt_tiny8's 8 (8 heads) and 32; K4 at the
# decode step, a verify of 4 drafts and the table of 3 blocks of 11 rows
# (an int8 code row of 8 or 24 bytes staged in 8-byte copies), K5 at
# the deepest prefix and a chunk of no power of two
HEAD_DIM_GEOMETRIES = ((16, 128), (4, 16), (8, 8), (4, 32))
K4_DIM_CASES = ((8, 1, None, 64, 16), (8, 5, None, 64, 16),
                (1, 16, (32,), 3, 11))
K5_DIM_SHAPES = ((128, 517), (100, 300))


def k4_case_inputs(torch, dtype, int8):
    """Every K4 case of phase 3 at q's ``dtype`` over fp pools (q's dtype)
    or int8 code pools, as dicts like :func:`k5_case_inputs`'. The decode
    step's offsets are ``linspace(0, 1000, b)`` shuffled; its inputs at s
    1 are drawn as they were before the other cases existed (seed 21, 22
    over int8 pools: pools, then offsets, then q)."""
    cases = [(K4_GEOMETRY, c, 100 * ci) for ci, c in enumerate(K4_CASES)]
    cases += [(g, c, 7 + 100 * ci + 1000 * gi)
              for gi, g in enumerate(HEAD_DIM_GEOMETRIES)
              for ci, c in enumerate(K4_DIM_CASES)]
    for (H, D), (b, s, starts, bp, bs), seed in cases:
        rs = np.random.RandomState((22 if int8 else 21) + seed)
        if int8:
            codes, scales, table_t, table = _pool_case_q(torch, rs, b, bp,
                                                         bs, H, D)
            pools = (codes, scales)
        else:
            kp, vp, table_t, table = _pool_case(torch, rs, b, bp, bs, H, D,
                                                dtype)
            pools = (kp, vp)
        if starts is None:
            t_np = np.linspace(0, 1000, b).round().astype(np.int32)
            rs.shuffle(t_np)
        else:
            t_np = np.asarray(starts, np.int32)
        t = torch.from_numpy(t_np).cuda()
        q = torch.from_numpy(rs.randn(b, s, H, D).astype(np.float32)).to(
            "cuda", dtype)
        nbytes, flops = _paged_cost(H, D, bs, bp, t_np, s, q.element_size(),
                                    int8, table.nbytes + 4 * b)
        shape = [b, s, H, D, bs, bp] if starts is None else \
            [b, s, list(starts), H, D, bs, bp]
        yield dict(q=q, pools=pools, table_t=table_t, table=table, t=t,
                   reach=t_np + s - 1, int8=int8, shape=shape,
                   nbytes=nbytes, flops=flops,
                   head_dim_case=(H, D) != K4_GEOMETRY)


def k4_run(torch, case):
    """K4 on one case, as :func:`k5_run` runs K5."""
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    return _paged_run(torch, case, k4.paged_attention, k4.paged_attention_ref)


def tol_key(dn: str, int8: bool) -> str:
    """The key of a tensor-core body's own gate in ``K4_TOL`` and
    ``K5_TOL`` for q's dtype name ``dn`` and the pools."""
    return {("bfloat16", False): "bf16", ("bfloat16", True): "int8",
            ("float16", False): "fp16", ("float16", True): "int8-fp16"}[
                (dn, int8)]


def k4_share(int8, outs, exact, dn="bfloat16") -> float:
    """K4's own measure of bf16 or fp16 q, against ``K4_TOL``, as
    :func:`k5_share` measures K5 against ``K5_TOL``."""
    return limit_share(K4_TOL[tol_key(dn, int8)], outs, exact)


def decode_phase(torch, timer, rows, int8):
    """K4 (``int8``: K4-int8) on every case, fp32, bf16 and fp16: the
    shared gate, and K4_TOL for bf16 and fp16 q, F32_PAGED_TOL for fp32;
    timed beside its plain version and SDPA over the dense view gathered
    (and dequantized) beforehand; then a bf16 q, an fp16 q and an fp32
    q's K pool its C entry must refuse."""
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    _paged_phase(torch, timer, rows, "K4-int8" if int8 else "K4",
                 k4_case_inputs, k4_run, K4_TOL, "k4", int8,
                 k4.paged_attention, k4.paged_attention_ref)
    if not int8:
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            _refuses_misaligned(torch, "K4", k4, k4.paged_attention,
                                next(k4_case_inputs(torch, dtype, False)))


# K5's cases (s, start): a prompt's first chunk, its second, a chunk over
# the serving path's deepest prefix, a chunk length of no power of two,
# and a chunk whose pad tail runs past the table's end; the int8 pools at
# the first, the deepest and the chunk of no power of two. Both pools also: a chunk running off a
# table of 5 blocks (80 rows, no multiple of a 64-key tile), whose last
# key tile holds 48 zero-filled rows past the reach that its 24 pad
# rows' positions would admit (unmasked, they would take a tenth or more
# of those rows' softmax); and for bf16 q three slots at their own
# starts (the kernel takes a start per slot).
K5_SHAPES = ((128, 0), (128, 128), (128, 517), (100, 300), (64, 1000))
K5_Q_SHAPES = ((128, 0), (128, 517), (100, 300))
K5_OFF_TABLE = (64, 40, 5)              # s, start, bp
K5_SLOTS = (128, (0, 517, 260))
K5_GEOMETRY = (12, 64, 16, 64)          # H, D, bs, bp: gpt2_small's


def k5_case_inputs(torch, dtype, int8, shapes=None):
    """Every K5 case of phase 3 at q's ``dtype`` (or the single-slot
    (s, start) ``shapes``), over fp pools (q's dtype) or int8 code pools:
    dicts of the inputs, the shape label and the bytes and operations a
    case must move and do."""
    H0, D0, bs, bp0 = K5_GEOMETRY
    if shapes is not None:
        cases = [(1, s, (start,), bp0) for s, start in shapes]
    else:
        cases = [(1, s, (start,), bp0) for s, start in
                 (K5_Q_SHAPES if int8 else K5_SHAPES)]
        cases.append((1, K5_OFF_TABLE[0], (K5_OFF_TABLE[1],),
                      K5_OFF_TABLE[2]))
        if dtype != torch.float32:
            cases.append((len(K5_SLOTS[1]), K5_SLOTS[0], K5_SLOTS[1], bp0))
    cases = [((H0, D0), c, 0) for c in cases]
    if shapes is None:
        cases += [(g, (1, s, (start,), bp0), 77 + 1000 * gi)
                  for gi, g in enumerate(HEAD_DIM_GEOMETRIES)
                  for s, start in K5_DIM_SHAPES]
    for (H, D), (b, s, starts, bp), seed in cases:
        rs = np.random.RandomState((32 if int8 else 31) + starts[0] + s
                                   + 1000 * (b - 1) + seed)
        if int8:
            codes, scales, table_t, table = _pool_case_q(torch, rs, b, bp,
                                                         bs, H, D)
            pools = (codes, scales)
        else:
            kp, vp, table_t, table = _pool_case(torch, rs, b, bp, bs, H, D,
                                                dtype)
            pools = (kp, vp)
        q = torch.from_numpy(rs.randn(b, s, H, D).astype(np.float32)).to(
            "cuda", dtype)
        t_np = np.asarray(starts, np.int32)
        t = (torch.tensor(starts[0], dtype=torch.int32, device="cuda")
             if b == 1 else torch.from_numpy(t_np).cuda())
        nbytes, flops = _paged_cost(H, D, bs, bp, t_np, s, q.element_size(),
                                    int8,
                                    table.nbytes + (4 * b if b > 1 else 0))
        shape = [s, starts[0], H, D, bs, bp] if b == 1 else \
            [b, s, list(starts), H, D, bs, bp]
        yield dict(q=q, pools=pools, table_t=table_t, table=table, t=t,
                   reach=t_np + s - 1, int8=int8, shape=shape,
                   nbytes=nbytes, flops=flops,
                   head_dim_case=(H, D) != (H0, D0))


def k5_run(torch, case):
    """K5 on one case (:func:`_paged_run`)."""
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5

    return _paged_run(torch, case, k5.chunk_prefill, k5.chunk_prefill_ref)


def _paged_run(torch, case, kernel_fn, ref_fn):
    """K4 or K5 (``kernel_fn``, its plain version ``ref_fn``) on one case:
    the kernel's outputs on clean pools, on pools poisoned where no query
    may read (1e9 rows or saturated codes, 1e7 scales in blocks no table
    names) and on pools with NaN there; the plain version in q's dtype
    (the shared gate's, the reference's order: int8 codes dequantized to
    q's dtype; at the other head dims the fp32 one) and in fp32 (the own
    gates'), clean and poisoned."""
    q, table_t, t = case["q"], case["table_t"], case["t"]

    def kern(a, b, sc=(None, None)):
        return kernel_fn(q, a, b, table_t, t, k_scale=sc[0], v_scale=sc[1])

    def plain(qq, a, b, sc=(None, None)):
        return ref_fn(qq, a, b, table_t, t, k_scale=sc[0], v_scale=sc[1])

    if case["int8"]:
        codes, scales = case["pools"]
        pc, px = _poison_q(torch, codes, scales, case["table"], case["reach"])
        nc, nx = _poison_q(torch, codes, scales, case["table"], case["reach"],
                           dead_scale=float("nan"))
        outs = (kern(*codes, scales), kern(*pc, px), kern(*nc, nx))
        shared = (plain(q, *codes, scales), plain(q, *pc, px))
        exact = (plain(q.float(), *codes, scales), plain(q.float(), *pc, px))
        if case["head_dim_case"]:
            # the other head dims' shared gate reads the fp32 plain
            # version: a bf16 plain version's own rounding of the
            # dequantized view (|v| up to ~4) reaches 2e-2 of the few
            # heads' largest output there (2.1e-2 to 2.8e-2 at d 8-32,
            # while the kernel stays within 0.39 of K4_TOL and K5_TOL of
            # the fp32 version), so it would gate the plain version
            shared = exact
    else:
        kp, vp = case["pools"]
        kpp, vpp = _poison(torch, kp, vp, case["table"], case["reach"])
        kpn, vpn = _poison(torch, kp, vp, case["table"], case["reach"],
                           dead=float("nan"))
        outs = (kern(kp, vp), kern(kpp, vpp), kern(kpn, vpn))
        exact = (plain(q.float(), kp.float(), vp.float()),
                 plain(q.float(), kpp.float(), vpp.float()))
        shared = exact
    torch.cuda.synchronize()
    return outs, shared, exact


def paged_shared_error(dn, int8, outs, shared):
    """The gate every K4/K5 case is held to: the largest |kernel - plain|
    over clean, poisoned, poisoned against clean and NaN-poisoned against
    clean, relative to max(1, max |plain|) for bf16 or fp16 q over int8
    pools (whose plain version rounds the dequantized view to q's dtype),
    else absolute."""
    out, out_p, out_n = outs
    ref, ref_p = shared
    err = max(_err(out, ref), _err(out_p, ref_p), _err(out_p, out),
              _err(out_n, out))
    norm = max(1.0, float(ref.float().abs().max())) \
        if int8 and dn != "float32" else 1.0
    return err, err / norm


def f32_share(int8, outs, exact) -> float:
    """The fp32 body's own measure (fp32 q, K4 or K5), against
    ``F32_PAGED_TOL``."""
    return limit_share(F32_PAGED_TOL["int8" if int8 else "fp32"], outs,
                       exact)


def k5_share(int8, outs, exact, dn="bfloat16") -> float:
    """K5's own measure of bf16 or fp16 q (:func:`limit_share` of
    ``K5_TOL``)."""
    return limit_share(K5_TOL[tol_key(dn, int8)], outs, exact)


def limit_share(tol, outs, exact) -> float:
    """A redesigned body's own measure: the largest |out - plain| / (atol
    + rtol |plain|) of any element, against the fp32 plain version, over
    clean, poisoned and NaN-poisoned pools (NaN if any is not finite)."""
    worst = 0.0
    for out, ref in zip(outs, (exact[0], exact[1], exact[0])):
        ref = ref.float()
        ratio = (out.float() - ref).abs() / (tol["atol"]
                                             + tol["rtol"] * ref.abs())
        if not _finite(ratio):
            return float("nan")
        worst = max(worst, float(ratio.max()))
    return worst


def _finite(x) -> bool:
    return bool(x.isfinite().all())


def chunk_phase(torch, timer, rows, int8):
    """K5 (``int8``: K5-int8) on every case, fp32, bf16 and fp16: the
    shared gate, and K5_TOL for bf16 and fp16 q, F32_PAGED_TOL for fp32;
    timed beside its plain version and SDPA over the dense view gathered
    (and dequantized) beforehand; then a bf16 q, an fp16 q and an fp32
    q's K pool its C entry must refuse."""
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5

    _paged_phase(torch, timer, rows, "K5-int8" if int8 else "K5",
                 k5_case_inputs, k5_run, K5_TOL, "k5", int8,
                 k5.chunk_prefill, k5.chunk_prefill_ref)
    if not int8:
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            _refuses_misaligned(torch, "K5", k5, k5.chunk_prefill,
                                next(k5_case_inputs(torch, dtype, False)))


def _paged_phase(torch, timer, rows, name, cases, run, tols, kid, int8,
                 kernel_fn, ref_fn):
    """Every case of ``cases`` (K4's or K5's generator), fp32, bf16 and
    fp16 q: ``run`` on it, the shared gate, the body's own gate
    (:func:`limit_share` against ``tols`` for bf16 and fp16 q, reported
    as ``<kid>_limit_share``, and
    against F32_PAGED_TOL for fp32 q, as ``f32_limit_share``), and the row
    timed beside its plain version and SDPA over the dense view gathered
    (and dequantized) beforehand."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dn = str(dtype).split(".")[1]
        for case in cases(torch, dtype, int8):
            shape = case["shape"]
            if dn == "float16" and shape not in FP16_CASES[name[:2]] \
                    and not case["head_dim_case"]:
                continue
            outs, shared, exact = run(torch, case)
            check(all(_finite(o) for o in outs),
                  f"{name} {dn} {shape}: non-finite output on a poisoned "
                  "pool")
            err, rel = paged_shared_error(dn, int8, outs, shared)
            check(rel <= ATOL[dn], f"{name} {dn} {shape}: max |kernel - "
                  f"plain| {err} (relative {rel}) > {ATOL[dn]} (clean, "
                  "poisoned, or poisoned vs clean)")
            if dn != "float32":
                tol, gate = tols[tol_key(dn, int8)], kid
            else:
                tol, gate = F32_PAGED_TOL["int8" if int8 else "fp32"], "f32"
            share = limit_share(tol, outs, exact)
            check(share <= 1.0, f"{name} {dn} {shape}: an element is off by "
                  f"{share} x (atol {tol['atol']} + rtol {tol['rtol']} "
                  "|plain|)")
            extra = {f"{gate}_limit_share": share, f"{gate}_tol": tol}
            q, table_t, t = case["q"], case["table_t"], case["t"]
            if int8:    # the library's view is dequantized beforehand
                (kc, vc), sc = case["pools"]
                kd, vd = ((c.float() * x[:, None, :, None]).to(q.dtype)
                          for c, x in zip((kc, vc), sc))
            else:
                (kc, vc), sc = case["pools"], (None, None)
                kd, vd = kc, vc
            _record(rows, name, dn, shape, err, timer,
                    lambda: kernel_fn(q, kc, vc, table_t, t, k_scale=sc[0],
                                      v_scale=sc[1]),
                    lambda: ref_fn(q, kc, vc, table_t, t, k_scale=sc[0],
                                   v_scale=sc[1]),
                    _sdpa_yardstick(torch, q, kd, vd, table_t, case["table"],
                                    t, case["reach"]),
                    nbytes=case["nbytes"], flops=case["flops"], **extra)


def _misaligned(torch, x):
    """A contiguous copy of ``x`` one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device="cuda")
    xm = buf[1:x.numel() + 1].view(x.shape)
    xm.copy_(x)
    check(xm.is_contiguous() and xm.data_ptr() % 16 != 0,
          "the misaligned case is not misaligned")
    return xm


def _refuses_misaligned(torch, name, mod, kernel_fn, case):
    """A bf16 or fp16 q one element past a 16-byte boundary reaches the C
    entry, which must refuse it (cudaErrorInvalidValue = 1): cp.async takes
    16-byte chunks; so must an fp32 q's K pool (the fp32 body stages K and
    V by cp.async too). Nothing is launched or counted."""
    q, (kp, vp) = case["q"], case["pools"]
    what = "k_pool" if q.dtype == torch.float32 else "q"
    if what == "q":
        q = _misaligned(torch, q)
    else:
        kp = _misaligned(torch, kp)
    dn = str(q.dtype).split(".")[1]
    before = mod.launches
    try:
        kernel_fn(q, kp, vp, case["table_t"], case["t"])
    except RuntimeError as e:
        check("CUDA error 1 " in str(e), f"{name} misaligned {what}: {e}")
    else:
        fail(f"{name} launched on a {dn} {what} misaligned for cp.async")
    check(mod.launches == before, f"{name} counted a refused launch")
    print(f"  {name} {dn}: a {what} misaligned by one element is refused by "
          "the C entry", flush=True)


# (B, S, H, D, causal): the training shape, non-causal, head_dim 128; the
# long-context route (S > 8192) runs through the public functional
FLASH_CASES = [(16, 1024, 12, 64, True), (2, 1024, 12, 64, False),
               (2, 1024, 6, 128, True)]
FLASH_LONG = (1, 8320, 2, 64, True)
# BERT-base's attention in phase 7a: batch 32 x 512, 12 heads, non-causal
FLASH_BERT = (32, 512, 12, 64, False)
# gpt3_1p3b's attention in phase 6g: batch 8 x 2048, 16 heads of 128,
# causal; and the small head dims at 8 x 1024, causal, as many heads as
# gpt_tiny8 (8 of 8), gpt_tiny (4 of 16) and 2 of 32 (a hidden of 64)
FLASH_GPT3 = (8, 2048, 16, 128, True)
FLASH_SMALL_D = [(8, 1024, 8, 8, True), (8, 1024, 4, 16, True),
                 (8, 1024, 2, 32, True)]
# the timed shapes of each dtype: fp16 (fp16 AMP's dtype) at the
# training shape, bf16 (AMP's) also at BERT's, GPT-3 XL's and the small
# head dims (and, as every dtype, the long-context route)
FLASH_TIMED = {"float32": FLASH_CASES,
               "bfloat16": FLASH_CASES + [FLASH_BERT, FLASH_GPT3]
               + FLASH_SMALL_D,
               "float16": FLASH_CASES[:1]}


def _rel_err(out, ref) -> float:
    return _err(out, ref) / max(1.0, float(ref.float().abs().max()))


def timed_gate(dn: str) -> str:
    """The gate of a timed case of dtype ``dn`` (its inputs from
    :func:`_flash_inputs`): FP16_SCALED for fp16, else the dtype's."""
    return FP16_SCALED if dn == "float16" else dn


def _flash_inputs(torch, B, S, H, D, dtype, seed):
    """q, k, v, dO of a timed shape; in fp16 q and k scaled by
    FP16_QK_SCALE (logits up to ~1e4), held to the FP16_SCALED gate."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qk = FP16_QK_SCALE if dtype == torch.float16 else 1.0
    return [(torch.randn(B, S, H, D, device="cuda", generator=g)
             * (qk if i < 2 else 1.0)).to(dtype)
            for i in range(4)]      # q, k, v, dO


def _flash_rows(torch, timer, rows, dn, shape, q, k, v, do, scale, causal,
                errs):
    """Time K1, K3a and the K3b pair at one shape (inputs as given) and
    record one row each; ``errs`` maps kernel id to its checked error
    (for the K3 kernels also the largest share of K3_TOL) under the
    gate :func:`timed_gate` names. The K3 rows'
    library call is SDPA's backward alone (its forward run once outside
    the events), with its forward + backward beside it."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    B, S, H, D = q.shape
    sz = q.element_size()
    n = B * S * H * D * sz            # bytes of one (B, S, H, D) tensor
    vec = B * H * S * 4               # bytes of lse or delta
    flops = 4 * B * H * S * S * D / (2 if causal else 1)
    o, lse = fa.flash_fwd_ref(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta, scale, causal)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))

    def library_fwd_bwd():
        out = TF.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        torch.autograd.grad(out, (ql, kl, vl), dot)

    out_l = TF.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    plain_bwd = timer(lambda: fa.flash_bwd_ref(*bwd), n=10)
    library_bwd = timer(lambda: torch.autograd.grad(
        out_l, (ql, kl, vl), dot, retain_graph=True), n=10)
    library_both = timer(library_fwd_bwd, n=10)
    del out_l
    for kid, fn, plain, library, nbytes, kflops in (
            ("K1", lambda: fa.flash_fwd(q, k, v, scale, causal),
             timer(lambda: fa.flash_fwd_ref(q, k, v, scale, causal), n=10),
             timer(lambda: TF.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal), n=10),
             4 * n + vec, flops),
            ("K3a", lambda: fa.flash_bwd_fused(*bwd), plain_bwd, library_bwd,
             7 * n + 2 * vec, 2.5 * flops),
            ("K3b-dkv", lambda: fa.flash_bwd_dkv(*bwd), plain_bwd,
             library_bwd, 6 * n + 2 * vec, 2.0 * flops),
            ("K3b-dq", lambda: fa.flash_bwd_dq(*bwd), plain_bwd, library_bwd,
             5 * n + 2 * vec, 1.5 * flops)):
        bound_ms, bound_by = _bound(nbytes, kflops, dn)
        gate = timed_gate(dn)
        row = {"kernel": kid, "dtype": dn, "shape": shape,
               "max_abs_err": errs[kid][0], "rel_err": errs[kid][1],
               "gate": gate, "tol": FLASH_TOL[gate],
               "kernel_ms": timer(fn, n=10),
               "plain_ms": plain, "library_ms": library,
               "bound_ms": bound_ms, "bound_by": bound_by}
        if kid == "K1":
            row.update(lse_err=errs[kid][2], o_limit_share=errs[kid][3],
                       k1_tol=K1_TOL[gate])
        else:
            row["library_fwd_bwd_ms"] = library_both
        if kid != "K1":
            row.update(k3_limit_share=errs[kid][2], k3_tol=K3_TOL[gate])
        rows.append(row)
        print("  " + json.dumps(row), flush=True)


def _flash_check(torch, dn, shape, pairs):
    """Worst (max |err|, relative err) over ``pairs`` (name -> (kernel,
    plain)); fails on a non-finite value or an error past FLASH_TOL."""
    worst = (0.0, 0.0)
    for name, (a, b) in pairs.items():
        check(bool(torch.isfinite(a.float()).all()),
              f"flash {dn} {shape}: non-finite {name}")
        e = (_err(a, b), _rel_err(a, b))
        check(e[1] <= FLASH_TOL[dn], f"flash {dn} {shape}: {name} relative "
              f"error {e[1]} > {FLASH_TOL[dn]}")
        worst = max(worst, e, key=lambda t: t[1])
    return worst


# the backward's outputs by name: a K3 kernel's gradients and the plain
# ones are dicts over (some of) these
GRADS = ("dQ", "dK", "dV")


def _grads(prefix, got, want):
    """(kernel, plain) pairs for :func:`_flash_check`, by output name."""
    return {f"{prefix}{n}": (a, want[n]) for n, a in got.items()}


def k1_errors(dn, o, ro, lse, rlse):
    """K1's own measures against its plain version under gate ``dn`` (a
    dtype's name, or FP16_SCALED): lse's max |err|, and the largest |O -
    plain| / (atol + rtol * |plain|) of any element (NaN if any O is not
    finite)."""
    tol = K1_TOL[dn]
    ro = ro.float()
    ratio = (o.float() - ro).abs() / (tol["atol"] + tol["rtol"] * ro.abs())
    return _err(lse, rlse), float(ratio.max())


def k1_passes(dn, o, ro, lse, rlse) -> bool:
    e_lse, ratio = k1_errors(dn, o, ro, lse, rlse)
    return e_lse <= K1_TOL[dn]["lse"] and ratio <= 1.0


def _k1_check(torch, dn, shape, o, ro, lse, rlse):
    """FLASH_TOL on O and lse, then K1's own limits; returns (max |err|,
    relative err, lse's max |err|, O's largest share of its limit)."""
    worst = _flash_check(torch, dn, shape, {"O": (o, ro), "lse": (lse, rlse)})
    e_lse, ratio = k1_errors(dn, o, ro, lse, rlse)
    check(e_lse <= K1_TOL[dn]["lse"], f"K1 {dn} {shape}: max |lse - plain| "
          f"{e_lse} > {K1_TOL[dn]['lse']}")
    check(ratio <= 1.0, f"K1 {dn} {shape}: an element of O is off by "
          f"{ratio} x (atol {K1_TOL[dn]['atol']} + rtol "
          f"{K1_TOL[dn]['rtol']} |plain|)")
    return worst + (e_lse, ratio)


def k3_errors(dn, got, want):
    """K3's own measure against the plain version: per output of ``got``
    (name -> gradient, whichever of GRADS the kernel computes; ``want``
    holds the plain three), the largest |out - plain| / (atol + rtol *
    |plain|) of any element (NaN if any element is not finite)."""
    tol = K3_TOL[dn]
    out = {}
    for name, a in got.items():
        b = want[name].float()
        ratio = (a.float() - b).abs() / (tol["atol"][name]
                                         + tol["rtol"] * b.abs())
        out[name] = float(ratio.max())
    return out


def k3_passes(dn, got, want) -> bool:
    return all(r <= 1.0 for r in k3_errors(dn, got, want).values())


def _k3_check(torch, dn, shape, kid, got, want):
    """FLASH_TOL on each gradient, then K3's own limits; returns (max
    |err|, relative err, the largest share of K3_TOL)."""
    worst = _flash_check(torch, dn, shape, _grads(f"{kid} ", got, want))
    shares = k3_errors(dn, got, want)
    for name, r in shares.items():
        check(r <= 1.0, f"{kid} {dn} {shape}: an element of {name} is off "
              f"by {r} x (atol {K3_TOL[dn]['atol'][name]} + rtol "
              f"{K3_TOL[dn]['rtol']} |plain|)")
    return worst + (max(shares.values()),)


def k3_grads(torch, q, k, v, do, causal):
    """The plain gradients and each K3 kernel's (K3a's dQ, dK, dV,
    K3b-dkv's dK, dV, K3b-dq's dQ; dicts by name) computed, as in
    training, from K1's lse (delta from the plain O), and the kernels'
    arguments."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    scale = 1.0 / q.shape[-1] ** 0.5
    lse = fa.flash_fwd(q, k, v, scale, causal)[1]
    ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
    want = dict(zip(GRADS, fa.flash_bwd_ref(q, k, v, do, rlse, delta, scale,
                                            causal)))
    bwd = (q, k, v, do, lse, delta, scale, causal)
    return want, {"K3a": dict(zip(GRADS, fa.flash_bwd_fused(*bwd))),
                  "K3b-dkv": dict(zip(GRADS[1:], fa.flash_bwd_dkv(*bwd))),
                  "K3b-dq": {"dQ": fa.flash_bwd_dq(*bwd)}}, bwd


def k3_route_grads(torch, q, k, v, do, causal):
    """The long-context route's gradients: q, k, v through the public
    ``F.scaled_dot_product_attention`` and ``.backward(do)`` (the
    backward kernels take lse from the route's forward and delta from its
    O), as dicts by the kernel that computes them (the streaming pair
    beyond 8192 keys, else K3a), with the plain gradients they are held
    to (lse and delta from the plain forward) and the route's O."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    out.backward(do)
    scale = 1.0 / q.shape[-1] ** 0.5
    ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
    want = dict(zip(GRADS, fa.flash_bwd_ref(q, k, v, do, rlse, delta, scale,
                                            causal)))
    if fa._use_streaming(q.shape[1], k.shape[1]):
        got = {"K3b-dkv": {"dK": kl.grad, "dV": vl.grad},
               "K3b-dq": {"dQ": ql.grad}}
    else:
        got = {"K3a": {"dQ": ql.grad, "dK": kl.grad, "dV": vl.grad}}
    return want, got, out.detach()


def k3_case_inputs(torch, dtype):
    """(name, (q, k, v, dO), causal) of every K3 case beyond the timed
    shapes: the K1 cases of :func:`k1_case_inputs`, each with a dO of q's
    layout (for the NaN-past-S cases a view of a NaN-padded buffer too)."""
    g = torch.Generator(device="cuda").manual_seed(59)
    for name, qkv, causal, _ in k1_case_inputs(torch, dtype):
        q = qkv[0]
        do = torch.randn(q.shape, device="cuda", generator=g).to(dtype)
        if name.startswith("NaN past S"):
            buf = torch.full((q.shape[0], q.shape[1] + 64, *q.shape[2:]),
                             float("nan"), device="cuda", dtype=dtype)
            buf[:, :q.shape[1]] = do
            do = buf[:, :q.shape[1]]
        yield name, (*qkv, do), causal


def k3_cases(torch, dtype):
    """Every case of :func:`k3_case_inputs` through K3a, K3b-dkv and
    K3b-dq against the plain version, both gates; then misaligned
    pointers handed to their C entry points, which must refuse them for
    bf16."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    dn = str(dtype).split(".")[1]
    for name, (q, k, v, do), causal in k3_case_inputs(torch, dtype):
        want, got, _ = k3_grads(torch, q, k, v, do, causal)
        torch.cuda.synchronize()
        for kid, grads in got.items():
            err = _k3_check(torch, dn, name, kid, grads, want)
            print(f"  {kid} {dn} {name}: max |err| {err[0]:.3g}, relative "
                  f"{err[1]:.3g}, at {err[2]:.3g} of K3_TOL", flush=True)
    if dtype == torch.float32:
        return
    lib = _build.load_library()
    q = torch.zeros(1, 128, 1, 64, device="cuda", dtype=dtype)
    vec = torch.zeros(1, 1, 128, device="cuda")
    acc = torch.zeros(1, 128, 1, 64, device="cuda")
    grads = [torch.empty_like(q) for _ in range(2)]
    p = [t.data_ptr() for t in (q, q, q, q, vec, vec)]
    tail = fa._tail(q, q, 0.125, True)
    for bad in (0, 3):    # q, then dO, 2 bytes past a 16-byte boundary
        args = list(p)
        args[bad] += 2
        errs = (lib.ptt_flash_bwd_fused(*args, acc.data_ptr(),
                                        *[t.data_ptr() for t in grads],
                                        *tail),
                lib.ptt_flash_bwd_dkv(*args, *[t.data_ptr() for t in grads],
                                      *tail),
                lib.ptt_flash_bwd_dq(*args, grads[0].data_ptr(), *tail))
        check(errs == (1, 1, 1), f"K3 {dn} took a misaligned "
              f"{'q' if bad == 0 else 'dO'} pointer (returned {errs})")
    print(f"  K3a, K3b-dkv, K3b-dq {dn} misaligned q or dO pointer: "
          "refused at the entry points (cudaError 1)", flush=True)


def k1_case_inputs(torch, dtype):
    """(name, (q, k, v), causal, layout) of every K1 case beyond the timed
    shapes: ragged lengths, Sq != Sk, GPT's strided per-head views
    (``layout`` "kept": the gate takes them without a copy), a view
    misaligned by one element ("copied" for bf16), and inputs sliced from
    a buffer whose rows past S hold NaN."""
    g = torch.Generator(device="cuda").manual_seed(53)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    # ragged: the public gate sends S 1000 to flash (_pick_block(1000,
    # 256) = 250); neither length is a multiple of a 64- or 128-row tile
    # (and the small head dims of gpt_tiny8, gpt_tiny and 32, each body
    # at its padded head dim of 64 with the columns past d zero-filled)
    for S, D, causal in ((1000, 64, True), (200, 128, False),
                         (1000, 8, True), (200, 8, False), (1000, 16, True),
                         (200, 16, False), (1000, 32, True),
                         (200, 32, False)):
        yield (f"ragged S {S} D {D} causal {causal}",
               (rand(2, S, 4, D), rand(2, S, 4, D), rand(2, S, 4, D)),
               causal, None)
    for causal in (True, False):
        yield (f"Sq 256 Sk 1024 causal {causal}",
               (rand(2, 256, 4, 64), rand(2, 1024, 4, 64),
                rand(2, 1024, 4, 64)), causal, None)
    # GPT's views (models/gpt.py: qkv.split(head_dim, -1) per head), and
    # gpt_tiny's 4 heads of 16
    yield ("GPT qkv views D 16", rand(2, 512, 4, 3 * 16).split(16, dim=-1),
           True, "kept")
    B, S, H, D = 2, 1024, 12, 64
    yield ("GPT qkv views", rand(B, S, H, 3 * D).split(D, dim=-1), True,
           "kept")
    # one element past an aligned base
    n = B * S * H * D
    yield ("misaligned view",
           tuple(rand(n + 1)[1:].view(B, S, H, D) for _ in range(3)), True,
           "kept" if dtype == torch.float32 else "copied")
    # NaN past S: a CTA whose tile runs past S must not read those rows
    S, pad = 1000, 64
    bufs = []
    for _ in range(3):
        buf = torch.full((B, S + pad, H, D), float("nan"), device="cuda",
                         dtype=dtype)
        buf[:, :S] = rand(B, S, H, D)
        bufs.append(buf[:, :S])
    for causal in (True, False):
        yield f"NaN past S {S} causal {causal}", tuple(bufs), causal, None


def k1_cases(torch, dtype):
    """Every case of :func:`k1_case_inputs` through the public wrapper
    against the plain version on the same views, with the layout gate's
    verdict checked; then a misaligned pointer handed to the C entry
    point, which must refuse it."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    dn = str(dtype).split(".")[1]
    for name, qkv, causal, layout in k1_case_inputs(torch, dtype):
        if layout is not None:
            got = fa.kernel_layout(*qkv)
            kept = [t.data_ptr() for t in got] == [t.data_ptr() for t in qkv]
            check(kept == (layout == "kept"), f"K1 {dn} {name}: the layout "
                  f"gate's views were not {layout}")
            check(dtype == torch.float32 or all(
                t.data_ptr() % 16 == 0 for t in got),
                f"K1 {dn} {name}: the layout gate passed a misaligned view")
        scale = 1.0 / qkv[0].shape[-1] ** 0.5
        o, lse = fa.flash_fwd(*qkv, scale, causal)
        ro, rlse = fa.flash_fwd_ref(*qkv, scale, causal)
        torch.cuda.synchronize()
        err = _k1_check(torch, dn, name, o, ro, lse, rlse)
        print(f"  K1 {dn} {name}: max |err| {err[0]:.3g}, relative "
              f"{err[1]:.3g}, lse {err[2]:.3g}, O at {err[3]:.3g} of its "
              "limit", flush=True)
    # a misaligned pointer that reaches the entry point: refused
    # (cudaErrorInvalidValue = 1) for bf16 and fp16, and the wrapper's
    # check raises
    if dtype != torch.float32:
        q = torch.zeros(1, 128, 1, 64, device="cuda", dtype=dtype)
        o = torch.empty_like(q)
        lse = torch.empty(1, 1, 128, device="cuda")
        err = _build.load_library().ptt_flash_fwd(
            q.data_ptr() + 2, q.data_ptr(), q.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *fa._tail(q, q, 0.125, True))
        check(err == 1, f"K1 {dn} took a misaligned pointer (returned {err})")
        try:
            _build.check(err, "flash forward kernel")
            fail("a refused K1 launch did not raise")
        except RuntimeError:
            pass
        print(f"  K1 {dn} misaligned pointer: refused at the entry point "
              f"(cudaError {err}), the wrapper raises", flush=True)


def flash_phase(torch, timer, rows):
    """K1, K3a, K3b against their plain versions; returns the launch
    counts of the long-context route's public call (bf16)."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    long_launches = None
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dn = str(dtype).split(".")[1]
        k1_cases(torch, dtype)
        k3_cases(torch, dtype)
        gate = timed_gate(dn)
        for ci, (B, S, H, D, causal) in enumerate(FLASH_TIMED[dn]):
            shape = [B, S, H, D, causal]
            q, k, v, do = _flash_inputs(torch, B, S, H, D, dtype, 41 + ci)
            scale = 1.0 / D ** 0.5
            o, lse = fa.flash_fwd(q, k, v, scale, causal)
            ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
            delta = (do.float() * ro.float()).sum(-1).transpose(
                1, 2).contiguous()
            want = dict(zip(GRADS, fa.flash_bwd_ref(q, k, v, do, rlse, delta,
                                                    scale, causal)))
            # the backward kernels recompute P from K1's lse, as in training
            bwd = (q, k, v, do, lse, delta, scale, causal)
            fused = dict(zip(GRADS, fa.flash_bwd_fused(*bwd)))
            split = dict(zip(GRADS, (fa.flash_bwd_dq(*bwd),
                                     *fa.flash_bwd_dkv(*bwd))))
            torch.cuda.synchronize()
            e_fwd = _k1_check(torch, gate, shape, o, ro, lse, rlse)
            e_fused = _k3_check(torch, gate, shape, "K3a", fused, want)
            e_dkv = _k3_check(torch, gate, shape, "K3b-dkv",
                              {n: split[n] for n in GRADS[1:]}, want)
            e_dq = _k3_check(torch, gate, shape, "K3b-dq",
                             {"dQ": split["dQ"]}, want)
            _flash_check(torch, gate, shape, _grads("split ", split, want))
            errs = {"K1": e_fwd, "K3a": e_fused, "K3b-dkv": e_dkv,
                    "K3b-dq": e_dq}
            _flash_rows(torch, timer, rows, dn, shape, q, k, v, do, scale,
                        causal, errs)

        # the long-context route, through the public functional: the
        # counters must show the streaming pair and not the fused kernel
        B, S, H, D, causal = FLASH_LONG
        shape = [B, S, H, D, causal]
        q, k, v, do = _flash_inputs(torch, B, S, H, D, dtype, 47)
        fa.reset_launches()
        want, route, out = k3_route_grads(torch, q, k, v, do, causal)
        torch.cuda.synchronize()
        got = dict(fa.launches)
        print(f"long-context route {dn} {shape}: launches {got}", flush=True)
        check(got == {"fwd": 1, "bwd_fused": 0, "bwd_dkv": 1, "bwd_dq": 1},
              f"long-context route launched {got}: expected the forward "
              "and the streaming dK/dV and dQ kernels once, the fused "
              "backward never")
        if dtype == torch.bfloat16:
            long_launches = got
        scale = 1.0 / D ** 0.5
        ro, rlse = fa.flash_fwd_ref(q, k, v, scale, causal)
        delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
        # lse from the same kernel on the same inputs, outside the count
        lse = fa.flash_fwd(q, k, v, scale, causal)[1]
        e_fwd = _k1_check(torch, gate, shape, out, ro, lse, rlse)
        _flash_check(torch, gate, shape, _grads("split ", {
            **route["K3b-dkv"], **route["K3b-dq"]}, want))
        e_dkv = _k3_check(torch, gate, shape, "K3b-dkv", route["K3b-dkv"],
                          want)
        e_dq = _k3_check(torch, gate, shape, "K3b-dq", route["K3b-dq"], want)
        fused = dict(zip(GRADS, fa.flash_bwd_fused(q, k, v, do, lse, delta,
                                                   scale, causal)))
        torch.cuda.synchronize()
        e_fused = _k3_check(torch, gate, shape, "K3a", fused, want)
        _flash_rows(torch, timer, rows, dn, shape, q, k, v, do, scale, causal,
                    {"K1": e_fwd, "K3a": e_fused, "K3b-dkv": e_dkv,
                     "K3b-dq": e_dq})
    return long_launches


def _serving_trace(vocab):
    """Phase 5's 16 requests from ``RandomState(0)``: prompts of 24-700
    tokens, 32-64 new, 12 greedy and 4 at temperature 0.8 / top-p 0.9.
    Returned as Request keyword dicts."""
    rs = np.random.RandomState(0)
    sampled = set(rs.choice(16, 4, replace=False).tolist())
    out = []
    for i in range(16):
        plen = int(rs.randint(24, 701))
        n = int(rs.randint(32, 65))
        prompt = rs.randint(0, vocab, plen).tolist()
        kw = (dict(temperature=0.8, top_p=0.9) if i in sampled
              else dict(greedy=True))
        out.append(dict(prompt=prompt, max_new_tokens=n, **kw))
    return out


# the counters in which a ServingEngine absorbs a failure and serves on
# (a retried dispatch, a quarantined request, a crashed tick the breaker
# took, a stall, a degraded swap, a dropped telemetry write): a run with
# nothing planted must read 0 in each
ABSORBED = ("serving_request_errors_total",
            "serving_nonfinite_logit_events_total",
            "serving_engine_errors_total", "serving_breaker_trips_total",
            "serving_dispatch_retries_total", "serving_dispatch_stalls_total",
            "serving_swap_fallbacks_total",
            "serving_flight_dump_failed_total",
            "serving_profiler_errors_total")


def _absorbed(eng):
    """Every failure ``eng`` absorbed, as {series: count} with the zeros
    left out: the counters of ``ABSORBED`` by label, the swap verdict
    ``fault``, the ProgramSets' own retry and stall counts (kept apart
    from the registry), the breaker's consecutive failures and trip
    state, and the dispatches past the watchdog right now."""
    reg = eng.telemetry.registry
    out = {}
    for name in ABSORBED:
        snap = reg.get(name).snapshot()
        for label, v in (snap.items() if isinstance(snap, dict)
                         else [(None, snap)]):
            out[name if label is None else f"{name}{{{label}}}"] = v
    out["serving_swap_decisions_total{fault}"] = reg.get(
        "serving_swap_decisions_total").snapshot().get("fault", 0.0)
    for ps in eng._program_sets():
        out["ProgramSet.retry_events"] = \
            out.get("ProgramSet.retry_events", 0) + ps.retry_events
        out["ProgramSet.stall_events"] = \
            out.get("ProgramSet.stall_events", 0) + ps.stall_events
    b = eng.breaker_state()
    out.update({"breaker failures": b["failures"],
                "breaker open": int(b["open"]),
                "stalls in progress": eng.dispatch_stalled()})
    return {k: v for k, v in out.items() if v}


def _check_absorbed(eng, what, want=None):
    """``_absorbed(eng)`` equals ``want`` (nothing, by default)."""
    got = _absorbed(eng)
    check(got == (want or {}), f"{what}: absorbed failures {got}, want "
          f"{want or {}}")


def _serve(torch, model, trace, block_size=16, poison=False, arm=None,
           reasons=("length", "eos"), prepare=None, **engine_kw):
    """One run of ``trace`` through ``ServingEngine(model, 8 slots, max_len
    1024, blocks of ``block_size`` (None: the dense arena), chunks of 128,
    **engine_kw)`` on the card, after a warm-up request (cuBLAS handles,
    the allocator) outside the counted run: the engine, the requests,
    their streams, the aggregate, the wall seconds and the launch counts
    of the run (every counter set to 0 just before it). ``poison`` fills
    every pool after the warm-up as phase 3 poisons (1e9, or saturated
    int8 codes and 1e7 scales): a row read before it was written, or
    restored wrong, wrecks the softmax it reaches. ``arm`` (a callable
    returning a context manager: a planted fault) wraps the counted run;
    a request it made the engine quarantine ends ``"error"``, and the
    caller checks what the engine absorbed. With nothing armed, every
    request must end with one of ``reasons`` and the engine must have
    absorbed nothing (``_check_absorbed``): a retried dispatch or a
    crashed tick the breaker took fails the run as a raise would. A
    score or embed request streams no tokens. ``prepare(eng)`` runs after
    the warm-up (a knob set for the counted run)."""
    from paddle_tpu_torch.inference import Request, ServingEngine
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    eng = ServingEngine(model, max_batch_slots=8, max_len=1024,
                        block_size=block_size, prefill_chunk=128, seed=0,
                        device="cuda", **engine_kw)
    eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4, greedy=True))
    eng.run()
    if poison:
        e = eng.engine
        for b in e.kbufs + e.vbufs:
            b.fill_(127 if e.quantized else 1e9)
        for x in (e.kscales or []) + (e.vscales or []):
            x.fill_(1e7)
    if prepare is not None:
        prepare(eng)
    streamed = {}
    reqs = [eng.submit(Request(on_token=lambda r, tok, done: streamed.
                               setdefault(r.id, []).append((tok, bool(done))),
                               **kw)) for kw in trace]
    torch.cuda.synchronize()
    for m in (k2, k4, k5):
        m.reset_launches()
    t0 = time.perf_counter()
    if arm is None:
        agg = eng.run().aggregate()
    else:
        with arm():
            agg = eng.run().aggregate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K2": k2.launches, "K4": k4.launches, "K5": k5.launches,
                "K4-int8": k4.launches_q, "K5-int8": k5.launches_q}
    if arm is None:
        _check_absorbed(eng, "serving")
    for r in reqs:
        if arm is not None and r.status == "done" and \
                r.finish_reason == "error":
            continue
        check(r.status == "done" and r.finish_reason in reasons,
              f"request {r.id} ended {r.status}/{r.finish_reason}")
        if r.kind != "generate":
            check(r.id not in streamed and r.tokens == [],
                  f"{r.kind} request {r.id} streamed tokens")
            continue
        # a dead-ended grammar retires after a token streamed as not
        # done (its on_finish tells the client)
        check([tk for tk, _ in streamed[r.id]] == r.tokens
              and (streamed[r.id][-1][1]
                   or r.finish_reason == "constraint_dead_end"),
              f"request {r.id}: the stream differs from its tokens")
    return eng, reqs, agg, wall, launches


def _check_launches(what, launches, L, chunks, steps, int8, paged=True,
                    extra_k2=0):
    """The kernels' counters against the engine's own chunk and step
    counts: K2 twice a layer and once at the end of every forward (plus
    ``extra_k2``, a draft model's), K4 a layer a decode step, K5 a layer
    a prefill chunk (int8 pools: their int8 counters, the fp ones 0; the
    dense arena: neither)."""
    q = "-int8" if int8 else ""
    want = {"K2": (2 * L + 1) * (chunks + steps) + extra_k2, "K4": 0,
            "K5": 0, "K4-int8": 0, "K5-int8": 0}
    if paged:
        want.update({f"K4{q}": L * steps, f"K5{q}": L * chunks})
    check(launches == want, f"{what}: launch counts {launches} != {want} "
          f"implied by {chunks} chunks and {steps} steps")


def _agreement(torch, model, reqs):
    """Greedy tokens equal to the argmax of a teacher-forced no-cache
    forward of prompt + tokens[:-1]: (agreeing, checked)."""
    agree = total = 0
    with torch.inference_mode():
        for r in reqs:
            if not r.greedy:
                continue
            ids = torch.tensor([list(r.prompt) + r.tokens[:-1]],
                               device="cuda")
            arg = model(ids)[0, len(r.prompt) - 1:].argmax(-1).cpu().numpy()
            agree += int((arg == np.asarray(r.tokens)).sum())
            total += len(r.tokens)
    return agree, total


def _perf_line(what, card, agg, wall):
    kv = agg.get("kv_bytes_in_use_peak")     # the paged arena's only
    return (f"{what} perf on {card}: {agg['aggregate_tokens_per_s']:.1f} "
            f"tokens/s, TTFT p50 {agg['ttft_p50_s'] * 1e3:.1f} ms, decode "
            f"step p50 {agg['decode_step_ms_p50']:.2f} ms, wall {wall:.2f} s"
            + ("" if kv is None else f", kv_bytes_in_use_peak {int(kv)}"))


def serving_phase(torch, card):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small

    # fp32 end to end (no TF32, set in main): the greedy check below
    # compares two fp32 computations of the same logits
    cfg = gpt2_small()
    # GPT's initialisers from a seeded generator: normal(0, 0.02), the
    # residual output projections scaled by 1/sqrt(2 * layers)
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    model.eval()
    _, reqs, agg, wall, launches = _serve(torch, model,
                                          _serving_trace(cfg.vocab_size))
    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    print(f"serving: {int(agg['completed'])} requests, {chunks} prefill "
          f"chunks, {steps} decode steps, {int(agg['preemptions'])} "
          f"preemptions, blocks peak {int(agg['blocks_in_use_peak'])}, "
          f"launches {launches}", flush=True)
    _check_launches("fp32 serving", launches, cfg.num_layers, chunks, steps,
                    int8=False)

    _greedy_consistency(torch, model, reqs, "greedy consistency")
    print(_perf_line("serving", card, agg, wall), flush=True)
    return launches, model, agg, reqs


def _greedy_consistency(torch, model, reqs, what):
    """A teacher-forced no-cache forward of prompt + tokens[:-1] must put
    its argmax on every emitted greedy token, except at a near-tie (top-2
    gap < 1e-3). The no-cache forward is off the serving path; its
    attention takes the flash kernel K1 wherever the gate of
    _local_attention allows (length >= 128 that tiles into blocks of >=
    64) and the plain _sdpa math elsewhere."""
    near_ties = checked = 0
    with torch.inference_mode():
        for r in reqs:
            if not r.greedy:
                continue
            ids = torch.tensor([list(r.prompt) + r.tokens[:-1]],
                               device="cuda")
            logits = model(ids)[0, len(r.prompt) - 1:].float()
            top2 = torch.topk(logits, 2, dim=-1).values
            arg = logits.argmax(dim=-1).cpu().numpy()
            gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            for pos, (a, tok, g) in enumerate(zip(arg, r.tokens, gap)):
                checked += 1
                if a != tok:
                    check(g < 1e-3, f"request {r.id} position {pos}: "
                          f"emitted {tok}, no-cache argmax {a}, top-2 gap "
                          f"{g}")
                    near_ties += 1
    print(f"{what}: {checked} tokens checked, {near_ties} near-tie "
          "mismatches (top-2 gap < 1e-3)", flush=True)
    return checked, near_ties


def _shared_prefix_trace(vocab):
    """16 requests from ``RandomState(1)``: one 512-token system prompt,
    then a 24-300-token suffix each; 32-64 new tokens; 12 greedy, 4 at
    temperature 0.8 / top-p 0.9. Returned as Request keyword dicts."""
    rs = np.random.RandomState(1)
    system = rs.randint(0, vocab, 512).tolist()
    sampled = set(rs.choice(16, 4, replace=False).tolist())
    out = []
    for i in range(16):
        suffix = rs.randint(0, vocab, int(rs.randint(24, 301))).tolist()
        kw = (dict(temperature=0.8, top_p=0.9) if i in sampled
              else dict(greedy=True))
        out.append(dict(prompt=system + suffix,
                        max_new_tokens=int(rs.randint(32, 65)), **kw))
    return out


def serving_q_phase(torch, card, model, fp_agg):
    """Phase 5b: int8 pools and the prefix cache on the same model;
    returns the int8 kernels' launch counts."""
    from paddle_tpu_torch.inference import PrefixCache

    cfg = model.config
    trace = _shared_prefix_trace(cfg.vocab_size)
    cache = PrefixCache(chunk_tokens=128, max_bytes=1 << 30)
    eng, reqs, agg, wall, launches = _serve(torch, model, trace,
                                            kv_dtype="int8",
                                            prefix_cache=cache)
    # the warm-up prompt is shorter than a chunk: it cached nothing and
    # hit nothing, so the trie's counter is the run's
    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    hits = int(agg["prefix_hit_tokens"])
    print(f"int8 + prefix cache: {int(agg['completed'])} requests, {chunks} "
          f"prefill chunks, {steps} decode steps, "
          f"{int(agg['preemptions'])} preemptions, prefix hit tokens "
          f"{hits} (rate {agg['prefix_hit_rate']:.3f}), evictions "
          f"{int(agg['evictions'])}, launches {launches}", flush=True)
    _check_launches("int8 serving", launches, cfg.num_layers, chunks, steps,
                    int8=True)
    check(hits > 0 and hits == cache.hit_tokens,
          f"prefix hit tokens {hits}, the trie's {cache.hit_tokens}")
    held = {b for n in cache.iter_nodes() for b in n.blocks}
    check(eng._alloc.blocks_in_use() == len(held),
          f"{eng._alloc.blocks_in_use()} blocks in use after the run, the "
          f"trie holds {len(held)}")

    # the same trace with the cache off, on int8 pools: token-exact for
    # the greedy requests (chunk_tokens == prefill_chunk, so a spliced
    # prefix holds the codes a cold prefill commits)
    _, cold, cold_agg, _, _ = _serve(torch, model, trace, kv_dtype="int8")
    for r, c in zip(reqs, cold):
        if r.greedy:
            check(r.tokens == c.tokens, f"int8 request {r.id}: cache on "
                  f"{r.tokens[:8]}... != cache off {c.tokens[:8]}...")
    print(f"cache on vs off (int8): greedy tokens equal; prefill chunks "
          f"{chunks} vs {int(cold_agg['prefill_chunks'])}", flush=True)

    # agreement with the fp32 teacher-forced no-cache argmax; the limit
    # is the reference's int8 contract (test_paged_kv.py:502)
    agree, total = _agreement(torch, model, reqs)
    rate = agree / total
    print(f"int8 greedy agreement with the fp32 argmax: {agree}/{total} = "
          f"{rate:.4f} (limit 0.9)", flush=True)
    check(rate >= 0.9, f"int8 greedy agreement {rate} < 0.9")
    print(_perf_line("int8 serving", card, agg, wall) + f" (phase 5, fp32: "
          f"{int(fp_agg['kv_bytes_in_use_peak'])}); cache off: "
          f"{cold_agg['aggregate_tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{cold_agg['ttft_p50_s'] * 1e3:.1f} ms, kv_bytes_in_use_peak "
          f"{int(cold_agg['kv_bytes_in_use_peak'])}", flush=True)
    return launches


def serving_bf16_phase(torch, card):
    """Phase 5c: ``gpt2_small`` in bf16 at full width and depth, whose
    chunk prefill launches K5's and whose decode steps launch K4's
    tensor-core body, serves phase 5's first 8
    greedy requests on bf16 pools, then on int8 pools: exact launch
    counts, every request done, and greedy agreement with the bf16
    teacher-forced argmax >= 0.9 (5b's limit, test_paged_kv.py:502).
    Returns the launch counts of the bf16-pool and the int8-pool run, the
    model, the two runs' aggregates and the bf16-pool run's requests."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small

    cfg = gpt2_small()
    model = GPTForCausalLM(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    model.eval()
    trace = [kw for kw in _serving_trace(cfg.vocab_size)
             if kw.get("greedy")][:8]
    out, aggs, served = {}, {}, {}
    for kv in (None, "int8"):
        what = f"bf16 serving{', int8 pools' if kv else ''}"
        _, reqs, agg, wall, launches = _serve(torch, model, trace,
                                              kv_dtype=kv)
        chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
        print(f"{what}: {int(agg['completed'])} requests, {chunks} prefill "
              f"chunks, {steps} decode steps, launches {launches}",
              flush=True)
        _check_launches(what, launches, cfg.num_layers, chunks, steps,
                        int8=kv is not None)
        agree, total = _agreement(torch, model, reqs)
        rate = agree / total
        print(f"{what}: greedy agreement with the bf16 argmax {agree}/"
              f"{total} = {rate:.4f} (limit 0.9)", flush=True)
        check(rate >= 0.9, f"{what}: greedy agreement {rate} < 0.9")
        print(_perf_line(what, card, agg, wall), flush=True)
        out[kv], aggs[kv], served[kv] = launches, agg, reqs
    return out[None], out["int8"], model, aggs, served[None]


def draws_check(torch):
    """``position_uniforms`` (the serving engine's position-keyed draws)
    on the card gives the CPU's bits, at key data that includes 0 and
    2**32 - 1, positions up to 2**31 and three lanes."""
    from paddle_tpu_torch.core.random import position_uniforms

    rs = np.random.RandomState(5)
    kd = rs.randint(0, 1 << 32, (64, 2), dtype=np.uint64).astype(np.int64)
    kd[0], kd[1] = 0, (1 << 32) - 1
    pos = rs.randint(0, 1 << 31, (64, 4)).astype(np.int64)
    pos[0, 0] = 0
    kd_t, pos_t = torch.from_numpy(kd), torch.from_numpy(pos)
    for lane in (0, 1, 7):
        cpu = position_uniforms(kd_t, pos_t, lane)
        dev = position_uniforms(kd_t.cuda(), pos_t.cuda(), lane)
        check(dev.device.type == "cuda" and torch.equal(dev.cpu(), cpu),
              f"position_uniforms lane {lane}: the card's bits differ "
              "from the CPU's")
    print(f"draws: position_uniforms on the card equals the CPU's bits at "
          f"{3 * pos.size} (keydata, P, lane)", flush=True)


def _spec_keys(agg):
    return {k: agg[k] for k in ("spec_verify_steps",
                                "spec_mean_accepted_per_step",
                                "spec_mean_tokens_per_step")}


def serving_spec_phase(torch, card, model, bf16_model, fp_agg, bf16_aggs,
                       rows):
    """Phase 5d: speculative serving, ``NgramDrafter(k=4)``, whose every
    decode half is a verify running K4 at s = 5 over the block table. The
    draws' bits against the CPU's; fp32 ``gpt2_small`` serving phase 5's
    trace (exact launch counts, greedy tokens against the teacher-forced
    argmax, near-ties counted); the bf16 model serving phase 5c's 8
    greedy requests on bf16 then int8 pools (exact launch counts,
    agreement >= 0.9); then the same on bf16 pools at k = 16, a verify
    of 17 query rows a slot (K4's bf16 body in two row tiles). Prints
    the spec keys, the host-clock perf beside phases 5 and 5c, and K4's
    rows at the verify shapes (phase 3) beside this phase's launches;
    returns the k = 16 run's K4 launches."""
    from paddle_tpu_torch.inference import NgramDrafter

    draws_check(torch)
    L = model.config.num_layers
    trace = _serving_trace(model.config.vocab_size)
    greedy8 = [kw for kw in trace if kw.get("greedy")][:8]
    runs = {}
    for what, mdl, tr, kv, k in (
            ("fp32 spec serving", model, trace, None, 4),
            ("bf16 spec serving", bf16_model, greedy8, None, 4),
            ("bf16 spec serving, int8 pools", bf16_model, greedy8, "int8",
             4),
            ("bf16 spec serving, k = 16", bf16_model, greedy8, None, 16)):
        _, reqs, agg, wall, launches = _serve(
            torch, mdl, tr, kv_dtype=kv, spec=NgramDrafter(k=k))
        chunks, steps = int(agg["prefill_chunks"]), \
            int(agg["spec_verify_steps"])
        check(agg["decode_steps"] == steps, f"{what}: {agg['decode_steps']} "
              f"decode steps, {steps} verify steps")
        print(f"{what}: {int(agg['completed'])} requests, {chunks} prefill "
              f"chunks, {steps} verify steps, {int(agg['preemptions'])} "
              f"preemptions, {_spec_keys(agg)}, launches {launches}",
              flush=True)
        _check_launches(what, launches, L, chunks, steps,
                        int8=kv is not None)
        if mdl is model:
            _greedy_consistency(torch, model, reqs, what)
        else:
            agree, total = _agreement(torch, mdl, reqs)
            rate = agree / total
            print(f"{what}: greedy agreement with the bf16 argmax {agree}/"
                  f"{total} = {rate:.4f} (limit 0.9)", flush=True)
            check(rate >= 0.9, f"{what}: greedy agreement {rate} < 0.9")
        print(_perf_line(what, card, agg, wall), flush=True)
        runs[what] = (agg, launches["K4-int8" if kv else "K4"], reqs)
    base = {"fp32 spec serving": ("phase 5", fp_agg),
            "bf16 spec serving": ("5c", bf16_aggs[None]),
            "bf16 spec serving, int8 pools": ("5c", bf16_aggs["int8"]),
            "bf16 spec serving, k = 16": ("5c", bf16_aggs[None])}
    print(f"spec vs plain serving on {card} (host clock, not gated): " +
          "; ".join(
              f"{w}: {a['aggregate_tokens_per_s']:.1f} tokens/s, decode "
              f"step p50 {a['decode_step_ms_p50']:.2f} ms ({base[w][0]}: "
              f"{base[w][1]['aggregate_tokens_per_s']:.1f}, "
              f"{base[w][1]['decode_step_ms_p50']:.2f} ms)"
              for w, (a, _, _) in runs.items()), flush=True)
    # K4 at the verify shapes: phase 3's cases of 8 slots at s 5 and s 17
    # over the decode step's table, beside the verify launches of this
    # phase
    launches = {("K4", "float32", 5): runs["fp32 spec serving"][1],
                ("K4", "bfloat16", 5): runs["bf16 spec serving"][1],
                ("K4-int8", "bfloat16", 5):
                    runs["bf16 spec serving, int8 pools"][1],
                ("K4", "bfloat16", 17): runs["bf16 spec serving, k = 16"][1]}
    for r in rows:
        if r["kernel"] in ("K4", "K4-int8") and \
                r["shape"] in ([8, 5, 12, 64, 16, 64],
                               [8, 17, 12, 64, 16, 64]):
            print("verify shape: " + json.dumps(dict(
                r, spec_launches=launches.get(
                    (r["kernel"], r["dtype"], r["shape"][1])))), flush=True)
    return runs["bf16 spec serving, k = 16"][1], \
        runs["fp32 spec serving"][2]


def serving_dense_phase(torch, card, model, fp_agg):
    """Phase 5e: phase 5's fp32 model and 16-request trace behind
    ``ServingEngine`` with ``block_size`` left at its default, the dense
    arena: greedy tokens against the teacher-forced argmax (near-ties
    counted), no K4 or K5 launch, K2 (2L + 1) x (chunks + steps), and the
    host-clock perf beside phase 5's (not gated). Then the dense arena's
    prefix cache: 5b's shared-prompt trace with and without a
    ``PrefixCache(chunk_tokens=128)`` (segment copies of cached chunks
    into the slot's rows): greedy tokens equal, hits > 0, K4 = K5 = 0."""
    cfg = model.config
    _, reqs, agg, wall, launches = _serve(
        torch, model, _serving_trace(cfg.vocab_size), block_size=None)
    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    print(f"dense serving: {int(agg['completed'])} requests, {chunks} "
          f"prefill chunks, {steps} decode steps, launches {launches}",
          flush=True)
    _check_launches("dense serving", launches, cfg.num_layers, chunks, steps,
                    int8=False, paged=False)
    _greedy_consistency(torch, model, reqs, "dense greedy consistency")
    print(_perf_line("dense serving", card, agg, wall) + " (phase 5, paged: "
          f"{fp_agg['aggregate_tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{fp_agg['ttft_p50_s'] * 1e3:.1f} ms, decode step p50 "
          f"{fp_agg['decode_step_ms_p50']:.2f} ms; host clock, not gated)",
          flush=True)

    from paddle_tpu_torch.inference import PrefixCache

    trace = _shared_prefix_trace(cfg.vocab_size)
    _, cold, cold_agg, _, _ = _serve(torch, model, trace, block_size=None)
    cache = PrefixCache(chunk_tokens=128, max_bytes=1 << 30)
    _, reqs, agg, wall, launches = _serve(torch, model, trace,
                                          block_size=None,
                                          prefix_cache=cache)
    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    hits = int(agg["prefix_hit_tokens"])
    print(f"dense serving + prefix cache: {int(agg['completed'])} requests, "
          f"{chunks} prefill chunks (cache off "
          f"{int(cold_agg['prefill_chunks'])}), {steps} decode steps, "
          f"prefix hit tokens {hits}, trie {cache.stats()}, launches "
          f"{launches}", flush=True)
    _check_launches("dense serving + prefix cache", launches,
                    cfg.num_layers, chunks, steps, int8=False, paged=False)
    check(hits > 0 and hits == cache.hit_tokens,
          f"dense prefix hit tokens {hits}, the trie's {cache.hit_tokens}")
    for r, c in zip(reqs, cold):
        if r.greedy:
            check(r.tokens == c.tokens, f"dense request {r.id}: cache on "
                  f"{r.tokens[:8]}... != cache off {c.tokens[:8]}...")
    print("dense cache on vs off: greedy tokens equal; "
          + _perf_line("dense serving + prefix cache", card, agg, wall),
          flush=True)


def serving_fp16_phase(torch, card):
    """Phase 5h: ``gpt2_small`` in fp16 at full width and depth serves
    5c's 8 greedy requests on fp16 pools, then on int8 pools, so that
    every LayerNorm runs K2's fp16 body, prefill K5's and decode K4's
    tensor-core bodies on ``__half``: the teacher-forced logits finite
    (fp16's range holds the random model), exact launch counts, and
    greedy agreement with the fp16 teacher-forced argmax >= 0.9 (5c's
    limit). Returns the launch counts of the two runs."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small

    cfg = gpt2_small()
    model = GPTForCausalLM(cfg, device="cuda", seed=0, dtype=torch.float16)
    model.eval()
    trace = [kw for kw in _serving_trace(cfg.vocab_size)
             if kw.get("greedy")][:8]
    with torch.inference_mode():
        ids = torch.tensor([trace[0]["prompt"]], device="cuda")
        logits = model(ids)
    check(logits.dtype == torch.float16 and _finite(logits),
          "fp16 gpt2_small: the teacher-forced logits are not finite fp16")
    print(f"fp16 teacher-forced logits: max |logit| "
          f"{float(logits.float().abs().max()):.3f}", flush=True)
    out = {}
    for kv in (None, "int8"):
        what = f"fp16 serving{', int8 pools' if kv else ''}"
        _, reqs, agg, wall, launches = _serve(torch, model, trace,
                                              kv_dtype=kv)
        chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
        print(f"{what}: {int(agg['completed'])} requests, {chunks} prefill "
              f"chunks, {steps} decode steps, launches {launches}",
              flush=True)
        _check_launches(what, launches, cfg.num_layers, chunks, steps,
                        int8=kv is not None)
        agree, total = _agreement(torch, model, reqs)
        rate = agree / total
        print(f"{what}: greedy agreement with the fp16 argmax {agree}/"
              f"{total} = {rate:.4f} (limit 0.9)", flush=True)
        check(rate >= 0.9, f"{what}: greedy agreement {rate} < 0.9")
        print(_perf_line(what, card, agg, wall), flush=True)
        out[kv] = launches
    return out[None], out["int8"]


def _same_greedy(torch, model, want, got, what):
    """Greedy requests of ``got`` give the tokens of ``want`` (the same
    trace), but at a near-tie: where they first differ, the top-2 gap of
    a teacher-forced no-cache forward of ``want``'s tokens must be below
    1e-3 (phase 5's rule; the two runs' K/V rows may come from different
    GEMM shapes, a decode step's or a chunk's). Returns the number of
    requests that diverged."""
    diverged = 0
    with torch.inference_mode():
        for w, g in zip(want, got):
            if not w.greedy or w.tokens == g.tokens:
                continue
            step = next(i for i, (a, b) in enumerate(zip(w.tokens, g.tokens))
                        if a != b)
            ids = torch.tensor([list(w.prompt) + w.tokens[:step]],
                               device="cuda")
            top2 = torch.topk(model(ids)[0, -1].float(), 2).values
            gap = float(top2[0] - top2[1])
            check(gap < 1e-3, f"{what}: request {w.id} diverges at token "
                  f"{step} ({w.tokens[step]} vs {g.tokens[step]}), top-2 "
                  f"gap {gap}")
            diverged += 1
    return diverged


# the starved pool of phase 5i: 170 blocks of 16 rows for 8 slots (the
# roomy run peaks at 279 on phase 5's trace), so growth preempts decoding
# requests (at 160 the one victim is still prefilling, and nothing
# spills); the tier takes every block a victim can hold
TIER_POOL = 170


def serving_tier_phase(torch, card, model):
    """Phase 5i: the host tier on phase 5's fp32 model and trace, over
    fp32 pools and then int8 pools, each poisoned after the warm-up.
    Three runs each: roomy, starved (``num_blocks=TIER_POOL``) without a
    tier, and starved with ``host_tier_blocks=TIER_POOL``: the same
    greedy tokens (but at counted near-ties), preemptions >= 1, blocks
    spilled and swapped in and re-prefill tokens avoided > 0, fewer
    prefill tokens computed than without a tier, exact launch counts
    (K5 a layer a chunk of the engine's own count: a swapped-back request
    resumes at its spilled frontier), and the tier and the pool back to
    empty. Then 5b's shared-prompt trace behind a ``PrefixCache`` whose
    budget holds 3 chunks, with a tier: demotions and host hits > 0, the
    greedy tokens of the run without a cache."""
    from paddle_tpu_torch.inference import PrefixCache

    cfg = model.config
    L = cfg.num_layers
    trace = _serving_trace(cfg.vocab_size)
    for kv in (None, "int8"):
        what = f"host tier{', int8 pools' if kv else ''}"
        _, roomy, _, _, _ = _serve(torch, model, trace, poison=True,
                                   kv_dtype=kv)
        _, starved, s_agg, _, _ = _serve(torch, model, trace, poison=True,
                                         kv_dtype=kv, num_blocks=TIER_POOL)
        eng, reqs, agg, wall, launches = _serve(
            torch, model, trace, poison=True, kv_dtype=kv,
            num_blocks=TIER_POOL, host_tier_blocks=TIER_POOL)
        chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
        keys = ("preemptions", "blocks_spilled", "blocks_swapped_in",
                "reprefill_tokens_avoided", "prefill_tokens_computed")
        print(f"{what}: {chunks} prefill chunks, {steps} decode steps, "
              + ", ".join(f"{k} {int(agg[k])}" for k in keys)
              + f"; without a tier: preemptions {int(s_agg['preemptions'])}"
              f", prefill_tokens_computed "
              f"{int(s_agg['prefill_tokens_computed'])}; tier "
              f"{eng.host_tier_state()}, launches {launches}", flush=True)
        _check_launches(what, launches, L, chunks, steps, int8=kv is not None)
        check(agg["preemptions"] >= 1 and s_agg["preemptions"] >= 1,
              f"{what}: the starved pool did not preempt")
        for k in keys[1:4]:
            check(agg[k] > 0, f"{what}: {k} is {agg[k]}")
        check(agg["prefill_tokens_computed"]
              < s_agg["prefill_tokens_computed"],
              f"{what}: {agg['prefill_tokens_computed']} prefill tokens "
              f"computed, {s_agg['prefill_tokens_computed']} without a tier")
        check(eng._alloc.free_count() == eng._alloc.capacity
              and eng._host.free_count() == eng._host.capacity
              and eng._host.reconcile({}) == {
                  "leaked_host_blocks": 0, "missing_host_refs": 0,
                  "host_free_list_errors": 0},
              f"{what}: blocks left after the run: pool "
              f"{eng._alloc.blocks_in_use()}, tier {eng.host_tier_state()}")
        n_no = _same_greedy(torch, model, roomy, starved,
                            f"{what}, starved without a tier")
        n_tier = _same_greedy(torch, model, roomy, reqs, f"{what}, tiered")
        if kv is None:
            tiered = reqs
        print(f"{what}: greedy tokens of the roomy run in the starved runs "
              f"but at {n_no} (no tier) and {n_tier} (tier) near-tie "
              "divergences; " + _perf_line(what, card, agg, wall),
              flush=True)

    trace = _shared_prefix_trace(cfg.vocab_size)
    cold_eng, cold, _, _, _ = _serve(torch, model, trace)
    cache = PrefixCache(chunk_tokens=128, max_bytes=3 * (128 // 16)
                        * cold_eng._alloc.block_nbytes)
    eng, reqs, agg, wall, launches = _serve(torch, model, trace,
                                            prefix_cache=cache,
                                            host_tier_blocks=256)
    st = cache.stats()
    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    print(f"host tier + prefix cache (budget 3 chunks): {chunks} prefill "
          f"chunks, {steps} decode steps, prefix hit tokens "
          f"{int(agg['prefix_hit_tokens'])}, trie {st}, launches {launches}",
          flush=True)
    _check_launches("host tier + prefix cache", launches, L, chunks, steps,
                    int8=False)
    check(st["host_demotions"] > 0 and st["host_hits"] > 0,
          f"host tier + prefix cache: demotions {st['host_demotions']}, "
          f"host hits {st['host_hits']}")
    for r, c in zip(reqs, cold):
        if r.greedy:
            check(r.tokens == c.tokens, f"tiered trie request {r.id}: "
                  f"{r.tokens[:8]}... != cache off {c.tokens[:8]}...")
    print("host tier + prefix cache: greedy tokens equal to the cache-off "
          "run", flush=True)
    return tiered


def _live_slot_past_prefill(slot):
    """``serving:tick``'s trigger for ``nan_kv(slot)``: the first tick at
    which ``slot`` holds a request that is decoding."""
    return lambda ctx: ctx["engine"]._slots[slot] is not None \
        and ctx["engine"]._pf[slot] is None


def _watch_scrubs(torch, eng, seen):
    """Record, right after every scrub of released blocks, whether every
    pool and scale row of those blocks reads 0. The watcher holds the
    engine weakly, so the engine and its pools still free on their last
    reference."""
    import weakref

    ref, cls = weakref.ref(eng.engine), type(eng.engine)

    def watched(slot=None, blocks=None, replica=0):
        e = ref()
        cls.scrub_slot_kv(e, slot=slot, blocks=blocks, replica=replica)
        if blocks:
            idx = torch.as_tensor(list(blocks), device="cuda")
            bufs = e.kbufs + e.vbufs + (e.kscales or []) + (e.vscales or [])
            seen.append((len(blocks),
                         all(bool((b[idx] == 0).all()) for b in bufs)))

    eng.engine.scrub_slot_kv = watched


# what the engine absorbs when the logit guard retires one request
GUARD_RETIRED = {"serving_request_errors_total{logit_guard}": 1.0,
                 "serving_nonfinite_logit_events_total": 1.0}


def _contained(torch, model, what, clean, faulted, eng, seen):
    """The containment checks of one planted NaN: exactly one request
    ended "error", counted under the guard's label; the others' greedy
    tokens equal the clean run's (near-ties counted), the victim's
    tokens a prefix of its clean ones; a clean audit; the scrubbed
    blocks read 0."""
    victims = [r for r in faulted if r.finish_reason == "error"]
    check(len(victims) == 1, f"{what}: {len(victims)} requests ended "
          "'error', want exactly the poisoned one")
    v = victims[0]
    want = clean[faulted.index(v)]
    check(v.tokens == want.tokens[:len(v.tokens)],
          f"{what}: the victim's tokens {v.tokens[:8]} are not a prefix of "
          f"its clean run's")
    _check_absorbed(eng, what, GUARD_RETIRED)
    report = eng.audit()
    check(report["leaked_blocks"] == 0 and report["orphaned_pins"] == 0
          and report["slot_errors"] == 0, f"{what}: audit {report}")
    check(len(seen) == 1 and seen[0][0] > 0 and seen[0][1],
          f"{what}: scrubs (blocks, all read 0): {seen}")
    others = [(c, f) for c, f in zip(clean, faulted) if f is not v]
    n = _same_greedy(torch, model, [c for c, _ in others],
                     [f for _, f in others], what)
    print(f"{what}: request {v.id} retired 'error' after {len(v.tokens)} "
          f"tokens, {seen[0][0]} blocks scrubbed to 0; the other "
          f"{len(others)} requests' greedy tokens equal the clean run's "
          f"but at {n} near-tie divergences; audit {report['leaked_blocks']}"
          f" leaked, {report['orphaned_pins']} orphaned", flush=True)


def _poisoned_prefix(torch, model):
    """A request that splices a poisoned shared prefix retires "error"
    before its first token (K5 over the poisoned blocks, the guard on
    the chunk's last row); requests that share nothing serve the tokens
    of a clean run."""
    from paddle_tpu_torch.inference import PrefixCache, Request, ServingEngine

    trace = _shared_prefix_trace(model.config.vocab_size)
    others = [dict(prompt=kw["prompt"][512:], greedy=True,
                   max_new_tokens=kw["max_new_tokens"])
              for kw in trace[1:5]]
    out = {}
    for poison in (False, True):
        eng = ServingEngine(model, max_batch_slots=8, max_len=1024,
                            block_size=16, prefill_chunk=128, seed=0,
                            prefix_cache=PrefixCache(chunk_tokens=128),
                            logit_guard=True, device="cuda")
        seeder = eng.submit(Request(prompt=trace[0]["prompt"],
                                    max_new_tokens=4, greedy=True))
        eng.run()
        check(seeder.finish_reason == "length", "poisoned prefix: seeder "
              f"ended {seeder.finish_reason}")
        if poison:
            nodes = list(eng._cache.iter_nodes())
            blocks = sorted({b for n in nodes for b in n.blocks})
            eng.engine.poison_slot_kv(0, table_row=blocks)
        streamed = []
        victim = eng.submit(Request(
            prompt=trace[1]["prompt"], max_new_tokens=8, greedy=True,
            on_token=lambda r, t, d: streamed.append(t)))
        reqs = [eng.submit(Request(**kw)) for kw in others]
        eng.run()
        _check_absorbed(eng, f"poisoned prefix, poison {poison}",
                        GUARD_RETIRED if poison else None)
        out[poison] = (victim, reqs, eng, streamed)
    (cv, creqs, _, _), (v, reqs, eng, streamed) = out[False], out[True]
    check(cv.finish_reason == "length" and cv.tokens,
          f"poisoned prefix: the clean victim ended {cv.finish_reason}")
    check(v.finish_reason == "error" and v.tokens == [] and streamed == [],
          f"poisoned prefix: the victim ended {v.finish_reason} with "
          f"{len(v.tokens)} tokens, {len(streamed)} streamed")
    check(all(r.finish_reason == "length" for r in reqs),
          "poisoned prefix: a request that shares nothing did not finish")
    n = _same_greedy(torch, model, creqs, reqs, "poisoned prefix")
    report = eng.audit()
    check(report["leaked_blocks"] == 0 and report["orphaned_pins"] == 0,
          f"poisoned prefix: audit {report}")
    print(f"poisoned prefix (fp32, K5's first token): the splicing request "
          f"retired 'error' before any token; the {len(reqs)} others equal "
          f"the clean run's but at {n} near-tie divergences", flush=True)


def _tick_anatomy(torch, card, model, fp_reqs):
    """5j(b): phase 5's trace with ``profile=True`` (and the watchdog
    armed at 30 s, so that closing a dispatch's window waits on its CUDA
    event and the ledger's device window runs to the kernels' end):
    tokens equal phase 5's unprofiled run, top-level coverage >= 0.95,
    then the phase shares, the dispatch ledger and the telemetry volume
    per decode step."""
    cfg = model.config
    eng, reqs, agg, wall, _ = _serve(torch, model,
                                     _serving_trace(cfg.vocab_size),
                                     profile=True, dispatch_stall_s=30.0)
    check([r.tokens for r in reqs] == [r.tokens for r in fp_reqs],
          "profiled serving: tokens differ from phase 5's unprofiled run")
    snap = eng.telemetry.profiler.snapshot()
    cov = snap["coverage_fraction"]
    check(0.95 <= cov <= 1.0 + 1e-9, f"profiled serving: top-level "
          f"coverage {cov}")
    check(eng.executable_count() == 2
          and eng.telemetry.recompile_events() == 0,
          f"profiled serving: {eng.executable_count()} programs, "
          f"{eng.telemetry.recompile_events()} recompiles")
    shares = ", ".join(
        f"{name} {ph['fraction_of_tick']:.4f}"
        for name, ph in sorted(snap["phases"].items(),
                               key=lambda kv: -kv[1]["seconds_total"]))
    print(f"tick anatomy on {card} (host clock; {snap['ticks']} ticks, "
          f"{snap['tick_seconds_total']:.4f} s, top-level coverage "
          f"{cov:.4f}): share of the tick wall: {shares}", flush=True)
    for name, st in sorted(eng.engine.programs.dispatch_stats().items()):
        warm = st["dispatches"] - st["cold_dispatches"]
        print(f"dispatch ledger {name}: {int(st['dispatches'])} dispatches "
              f"({int(st['cold_dispatches'])} cold); per warm dispatch: "
              f"enqueue {1e3 * st['enqueue_s'] / warm:.3f} ms, device "
              f"window {1e3 * st['device_window_s'] / warm:.3f} ms, wall "
              f"{1e3 * st['wall_s'] / warm:.3f} ms", flush=True)
    steps = agg["decode_steps"]
    print(f"telemetry volume: {eng.telemetry.events_emitted()} events "
          f"emitted (warm-up included) over {int(steps)} decode steps; "
          f"profiler spans {eng.telemetry.profiler.total_events}; "
          + _perf_line("profiled serving", card, agg, wall), flush=True)


def _silent_telemetry():
    """A ``Telemetry`` that drops what it is given: the recorder's and
    the tracer's events and the SLO tracker's observations go nowhere,
    the sentinel is off, and every metric but the ``ABSORBED`` counters
    (which move only on a failure) drops its updates. What stays is the
    engine's own: the ProgramSet's signatures, fault points and ledger
    clocks, and the guard around each telemetry call."""
    from paddle_tpu_torch.observability import MetricsRegistry, Telemetry

    def drop(*args, **kw):
        return None

    class Silent(MetricsRegistry):
        def _get(self, cls, name, help, **kw):
            m = super()._get(cls, name, help, **kw)
            if name not in ABSORBED:
                m._inc = m._set = m._observe = drop
            return m

    tel = Telemetry(registry=Silent())
    tel.recorder.record = drop
    tel.tracer.lifecycle = tel.tracer.event = tel.tracer.span = drop
    tel.slo.observe = drop
    tel.sentinel.enabled = False
    return tel


# each arm first and last equally often, so a drift of the host's speed
# over the runs cancels in the difference of the means
TELEMETRY_ORDER = ("on", "off", "off", "on") * 2


def _telemetry_cost(torch, card, model, fp_reqs, fp_launches):
    """5j(b): what the always-on telemetry costs the serving tick. Phase
    5's trace with the engine's default ``Telemetry`` ("on") and with
    ``_silent_telemetry()`` ("off"), in the order ``TELEMETRY_ORDER``:
    each run gives phase 5's tokens and launch counts, "off" emits no
    event; printed (host clock, not gated): each run's wall and decode
    step p50, the difference of the two arms' means per decode step,
    and the spread of the walls within an arm beside it."""
    trace = _serving_trace(model.config.vocab_size)
    runs = {"on": [], "off": []}
    for arm in TELEMETRY_ORDER:
        kw = {} if arm == "on" else {"telemetry": _silent_telemetry()}
        eng, reqs, agg, wall, launches = _serve(torch, model, trace, **kw)
        check([r.tokens for r in reqs] == [r.tokens for r in fp_reqs]
              and launches == fp_launches, f"telemetry {arm}: tokens or "
              f"launches {launches} differ from phase 5's {fp_launches}")
        events = eng.telemetry.events_emitted()
        check((events > 0) == (arm == "on"),
              f"telemetry {arm}: {events} events emitted")
        runs[arm].append((wall, agg["decode_step_ms_p50"],
                          int(agg["decode_steps"])))
    mean = {a: [float(np.mean(c)) for c in zip(*r)] for a, r in runs.items()}
    steps = mean["on"][2]
    dwall = 1e3 * (mean["on"][0] - mean["off"][0])
    spread = {a: 1e3 * (max(w for w, _, _ in r) - min(w for w, _, _ in r))
              for a, r in runs.items()}
    print(f"telemetry cost on {card} (host clock, not gated; phase 5's "
          f"trace, order {TELEMETRY_ORDER}): " + "; ".join(
              f"{a}: walls {[round(w, 4) for w, _, _ in r]} s, decode step "
              f"p50 {[round(p, 3) for _, p, _ in r]} ms"
              for a, r in runs.items())
          + f"; mean wall on - off {dwall:.2f} ms over {steps:.0f} decode "
          f"steps, {dwall / steps:.3f} ms a step; decode step p50 on - off "
          f"{mean['on'][1] - mean['off'][1]:.3f} ms; spread of the walls "
          f"within an arm: on {spread['on']:.2f} ms, off "
          f"{spread['off']:.2f} ms", flush=True)


def _dispatch_faults(torch, model, trace, clean):
    """5j(c): a 0.2 s sleep at one warm decode dispatch under a 0.05 s
    watchdog gives exactly one ``dispatch_stall`` event; a raise on a
    dispatch's first attempt is absorbed by one counted retry; a raise at
    ``serving:tick`` counts one engine error and the trace finishes. The
    tokens equal the clean run's each time."""
    from paddle_tpu_torch.testing import fault_injection as fi

    def third_warm_step():
        calls = {"n": 0}

        def when(ctx):
            if ctx["program"] != "decode_step":
                return False
            calls["n"] += 1
            return calls["n"] == 3
        return when

    cases = [
        ("stall", dict(dispatch_stall_s=0.05), {
            "serving_dispatch_stalls_total": 1.0,
            "ProgramSet.stall_events": 1},
         lambda: fi.inject("serving:dispatch", fi.sleep_(0.2),
                           when=third_warm_step(), times=1)),
        ("retry", {}, {"serving_dispatch_retries_total": 1.0,
                       "ProgramSet.retry_events": 1},
         lambda: fi.inject("serving:dispatch", fi.raise_(RuntimeError(
             "planted dispatch fault")),
             when=lambda ctx: ctx["attempt"] == 0, times=1)),
        ("tick", {}, {"serving_engine_errors_total": 1.0},
         lambda: fi.inject("serving:tick", fi.raise_(RuntimeError(
             "planted tick crash")), when=lambda ctx: ctx["step"] > 20,
             times=1)),
    ]
    for what, kw, want, arm in cases:
        eng, reqs, _, _, _ = _serve(torch, model, trace, arm=arm, **kw)
        _check_absorbed(eng, f"dispatch faults, {what}", want)
        stalls = len(eng.telemetry.recorder.events(kind="dispatch_stall"))
        check(stalls == (what == "stall"), f"dispatch faults, {what}: "
              f"{stalls} dispatch_stall events")
        check([r.tokens for r in reqs] == [r.tokens for r in clean],
              f"dispatch faults, {what}: tokens differ from the clean run")
        print(f"dispatch faults, {what}: absorbed {want}, "
              f"{stalls} dispatch_stall events; tokens equal the clean "
              "run's", flush=True)


def serving_resilience_phase(torch, card, model, bf16_model, fp_launches,
                             fp_reqs, bf16_launches, bf16_reqs):
    """Phase 5j: serving telemetry and request-scoped resilience at full
    width. (a) containment: ``logit_guard=True`` with ``nan_kv`` armed at
    ``serving:tick`` on one live slot, over fp32 pools (phase 5's trace),
    bf16 pools (the bf16 model, 5c's 8 requests) and int8 pools (the
    fp32 model, 5c's 8 requests), then a poisoned shared prefix: exactly
    the poisoned request ends "error", counted under
    ``serving_request_errors_total{where="logit_guard"}``, the others'
    greedy tokens equal a clean run's, a clean audit, the scrubbed
    blocks read 0, and the clean guarded run gives the tokens and the K2,
    K4 and K5 launches of the same trace with the guard off; (b) the
    tick anatomy of phase 5's trace with ``profile=True``, and the cost
    of the always-on telemetry; (c) dispatch faults. Every engine
    absorbs exactly the planted failure (``_check_absorbed``)."""
    from paddle_tpu_torch.testing import fault_injection as fi

    cfg = model.config
    L = cfg.num_layers
    trace = _serving_trace(cfg.vocab_size)
    greedy8 = [kw for kw in trace if kw.get("greedy")][:8]
    for what, mdl, tr, kv, off, base in (
            ("guard, fp32", model, trace, None, fp_launches, fp_reqs),
            ("guard, bf16", bf16_model, greedy8, None, bf16_launches,
             bf16_reqs),
            ("guard, int8 pools", model, greedy8, "int8", None, None)):
        if off is None:
            _, base, _, _, off = _serve(torch, mdl, tr, kv_dtype=kv)
        _, clean, c_agg, _, on = _serve(torch, mdl, tr, kv_dtype=kv,
                                        logit_guard=True)
        check(on == off, f"{what}: guarded launches {on} != unguarded "
              f"{off}")
        _check_launches(what, on, L, int(c_agg["prefill_chunks"]),
                        int(c_agg["decode_steps"]), int8=kv is not None)
        check([r.tokens for r in clean] == [r.tokens for r in base],
              f"{what}: guarded tokens differ from the unguarded run's")
        seen = []

        def poison(ctx, seen=seen):
            # the scrub watcher rides the planted fault onto the engine
            _watch_scrubs(torch, ctx["engine"], seen)
            fi.nan_kv(0)(ctx)

        eng, faulted, agg, _, launches = _serve(
            torch, mdl, tr, kv_dtype=kv, logit_guard=True,
            arm=lambda: fi.inject("serving:tick", poison,
                                  when=_live_slot_past_prefill(0), times=1))
        _check_launches(what + ", faulted", launches, L,
                        int(agg["prefill_chunks"]), int(agg["decode_steps"]),
                        int8=kv is not None)
        _contained(torch, mdl, what, clean, faulted, eng, seen)
    _poisoned_prefix(torch, model)
    _tick_anatomy(torch, card, model, fp_reqs)
    _telemetry_cost(torch, card, model, fp_reqs, fp_launches)
    _, clean8, _, _, _ = _serve(torch, model, greedy8)
    _dispatch_faults(torch, model, greedy8, clean8)
    # a planted raise's traceback holds its engine in a reference cycle
    # (the exception, the fault point's frame, the injector): collect
    # them, so later phases' peak memory is their own
    import gc

    gc.collect()

GENERATE = (4, 256, 32)       # batch, prompt length, new tokens


def generate_phase(torch, card, model):
    """Phase 5f: ``model.generate`` on ``gpt2_small`` fp32, batch 4 of
    256-token prompts, 32 new tokens, ``top_k=1``, through the concat
    caches (``use_cache=True``), the whole sequence each token
    (``use_cache=False``) and the dense engine (``jit=True``): each path's
    tokens are the teacher-forced argmax of its own sequence but at
    near-ties (so the paths agree up to counted near-ties), and K1
    launches L times in every forward whose attention the flash gate
    admits (counted from ``_flash_gate`` itself), K2 (2L + 1) times a
    forward. Returns K1's launches."""
    from paddle_tpu_torch.nn.functional.attention import _flash_gate
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    b, s0, n = GENERATE
    L = model.config.num_layers
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, model.config.vocab_size, (b, s0))).cuda()
    model.generate(ids[:, :8], 2, top_k=1)         # warm-up, not counted
    outs, secs = {}, {}
    torch.cuda.synchronize()
    for m in (fa, k2):
        m.reset_launches()
    for what, kw in (("use_cache=True", {}),
                     ("use_cache=False", dict(use_cache=False)),
                     ("jit=True", dict(jit=True))):
        t0 = time.perf_counter()
        outs[what] = model.generate(ids, n, top_k=1, **kw)
        torch.cuda.synchronize()
        secs[what] = time.perf_counter() - t0
    k1, k2n = fa.launches["fwd"], k2.launches
    # forwards: the cached path's prompt and n - 1 one-token steps; the
    # uncached path's n whole sequences; the dense engine's prompt chunks
    # (of 128) and n - 1 steps
    chunks = b * -(-s0 // 128)
    fwd = {"use_cache=True": [(s0, s0)] + [(1, s0 + i)
                                            for i in range(1, n)],
           "use_cache=False": [(s0 + i, s0 + i) for i in range(n)]}
    gated = sum(_flash_gate(sq, sk, True, False)
                for f in fwd.values() for sq, sk in f)
    forwards = sum(len(f) for f in fwd.values()) + chunks + n - 1
    print(f"generate: {b} x {s0} + {n}, K1 launches {k1} (gate admits "
          f"{gated} forwards), K2 {k2n} over {forwards} forwards; host "
          "clock (not gated): " + ", ".join(
              f"{w} {b * n / t:.1f} tokens/s" for w, t in secs.items()),
          flush=True)
    check(k1 == L * gated and k2n == (2 * L + 1) * forwards,
          f"generate: K1 {k1} != {L} x {gated} or K2 {k2n} != "
          f"{2 * L + 1} x {forwards}")
    for what, out in outs.items():
        check(tuple(out.shape) == (b, s0 + n) and torch.equal(out[:, :s0],
                                                              ids),
              f"generate {what}: shape {tuple(out.shape)}")
        reqs = [_Greedy(out[i, :s0].tolist(), out[i, s0:].tolist())
                for i in range(b)]
        _greedy_consistency(torch, model, reqs, f"generate {what}")
    same = {w: int((o == outs["use_cache=True"]).all(dim=1).sum())
            for w, o in outs.items()}
    print(f"generate: rows equal to use_cache=True's: {same} of {b}",
          flush=True)
    return k1


class _Greedy:
    """A greedy request's prompt and tokens, as _greedy_consistency reads
    them."""

    def __init__(self, prompt, tokens, rid=0):
        self.prompt, self.tokens, self.greedy, self.id = prompt, tokens, \
            True, rid


def draft_phase(torch, card, model):
    """Phase 5g: phase 5's fp32 ``gpt2_small`` as the target, on the paged
    arena (blocks of 16) and on the dense one, serving 5c's 8 greedy
    requests with ``DraftModelDrafter(draft, k=4)``: a self-draft (a
    second model carrying the target's weights) must accept at least 0.9
    of accept_cap = 3 drafts a verify, and an independent 2-layer draft
    at the target's width (another seed) must give the tokens of the
    run without speculation, up to counted near-ties; exact launch
    counts for the target's K4/K5 (paged) and K2 over target and
    draft."""
    from paddle_tpu_torch.inference import DraftModelDrafter
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small

    cfg = model.config
    L = cfg.num_layers
    greedy8 = [kw for kw in _serving_trace(cfg.vocab_size)
               if kw.get("greedy")][:8]
    selfd = GPTForCausalLM(gpt2_small(), device="cuda", seed=1)
    selfd.load_state_dict(model.state_dict())
    small = gpt2_small()
    small.num_layers = 2
    indep = GPTForCausalLM(small, device="cuda", seed=1)
    for m in (selfd, indep):
        m.eval()
    for arena, bs in (("paged", 16), ("dense", None)):
        _, plain, _, _, _ = _serve(torch, model, greedy8, block_size=bs)
        for what, draft in (("self-draft", selfd), ("2-layer draft", indep)):
            name = f"draft-model spec serving, {arena}, {what}"
            _, reqs, agg, wall, launches = _serve(
                torch, model, greedy8, block_size=bs,
                spec=DraftModelDrafter(draft, k=4))
            chunks = int(agg["prefill_chunks"])
            steps = int(agg["spec_verify_steps"])
            Ld = draft.config.num_layers
            # the draft prefills what the target prefills, in chunks of
            # 128, and steps k = 4 times a verify
            print(f"{name}: {chunks} prefill chunks, {steps} verify steps, "
                  f"{_spec_keys(agg)}, launches {launches}", flush=True)
            _check_launches(name, launches, L, chunks, steps, int8=False,
                            paged=bs is not None,
                            extra_k2=(2 * Ld + 1) * (chunks + 4 * steps))
            acc = agg["spec_mean_accepted_per_step"]
            if draft is selfd:
                check(acc >= 0.9 * 3, f"{name}: {acc} drafts accepted a "
                      "verify, < 0.9 x accept_cap 3")
            _greedy_consistency(torch, model, reqs, name)
            diff = sum(r.tokens != p.tokens for r, p in zip(reqs, plain))
            print(f"{name}: {diff} of {len(reqs)} requests differ from the "
                  "run without speculation (each held to the argmax "
                  "above); " + _perf_line(name, card, agg, wall),
                  flush=True)
    del selfd, indep


# ------------------------------------------------- 5k: front door, fleet
# phase 5's trace, each request in the mix of 5k: the 12 greedy prompts
# alternate greedy and top-k 1 (which must draw the argmax), the 4
# sampled ones cycle through temperature 0.8, top-k 40 and top-p 0.9
MIX_SAMPLED = ({"temperature": 0.8}, {"top_k": 40}, {"top_p": 0.9})


def _mix_of(trace):
    out, g, s = [], 0, 0
    for kw in trace:
        if kw.get("greedy"):
            out.append({"greedy": True} if g % 2 == 0 else {"top_k": 1})
            g += 1
        else:
            out.append(MIX_SAMPLED[s % len(MIX_SAMPLED)])
            s += 1
    return out


def _wait_for(cond, what, timeout=120.0):
    t0 = time.monotonic()
    while not cond():
        check(time.monotonic() - t0 < timeout, f"{what}: timed out")
        time.sleep(0.002)


def _same_as_phase5(torch, model, fp_reqs, i, tokens, what):
    """Greedy tokens of phase 5's request ``i`` (``fp_reqs[i]``) equal
    ``tokens``, or differ first at a near-tie (phase 5's rule); returns
    1 when they diverged."""
    got = type("R", (), {"tokens": list(tokens)})()
    return _same_greedy(torch, model, [fp_reqs[i]], [got], what)


def _front_door_5k(torch, card, model, fp_reqs):
    """5k(a): a ``FrontDoor`` over phase 5's engine configuration, two
    tenants, two threads submitting phase 5's 16 prompts mid-flight in
    the sampling mix, four top-k 1 twins of greedy requests, a queued and
    a running cancel and a deadline no request can meet."""
    from paddle_tpu_torch.inference.frontend import (FrontDoor,
                                                     SamplingParams, Tenant)
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.ops.kernels import paged_attention as k4
    import threading

    cfg = model.config
    trace = _serving_trace(cfg.vocab_size)
    mix = _mix_of(trace)
    twins = [i for i, kw in enumerate(trace) if kw.get("greedy")][:8:2]
    door = FrontDoor(model, tenants=[Tenant("paid", weight=4, tier=0),
                                     Tenant("free", weight=1, tier=1)],
                     max_batch_slots=8, max_len=1024, block_size=16,
                     prefill_chunk=128, seed=0, device="cuda", profile=True)
    eng = door.engine
    handles, twin_h, errs = {}, {}, []

    def client(tenant, idx):
        try:
            for i in idx:
                kw = trace[i]
                handles[i] = door.submit(
                    kw["prompt"], tenant=tenant,
                    max_new_tokens=kw["max_new_tokens"],
                    sampling=SamplingParams(**mix[i]))
                if i in twins:
                    twin_h[i] = door.submit(
                        kw["prompt"], tenant=tenant,
                        max_new_tokens=kw["max_new_tokens"],
                        sampling=SamplingParams(top_k=1))
        except BaseException as e:      # noqa: BLE001 - checked below
            errs.append(repr(e))

    torch.cuda.synchronize()
    for m in (k2, k4, k5):
        m.reset_launches()
    t0 = time.perf_counter()
    door.start()
    try:
        threads = [threading.Thread(target=client, args=(t, range(b, 16, 2)))
                   for t, b in (("paid", 0), ("free", 1))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        check(not errs and not any(th.is_alive() for th in threads),
              f"front door: submitting threads failed {errs}")
        late = door.submit(trace[1]["prompt"], max_new_tokens=64,
                           deadline=0.05,
                           sampling=SamplingParams(greedy=True))
        queued = door.submit(trace[2]["prompt"], tenant="free",
                             max_new_tokens=8)
        check(queued.cancel(), "front door: queued cancel refused")
        victim = handles[max(handles, key=lambda i:
                             trace[i]["max_new_tokens"])]
        _wait_for(lambda: len(victim.tokens) >= 2 or
                  victim.status == "done", "front door: running victim")
        check(victim.status != "done", "front door: the running victim "
              "finished before its cancel")
        check(victim.cancel(), "front door: running cancel refused")
        for h in (list(handles.values()) + list(twin_h.values())
                  + [late, queued, victim]):
            check(h.wait(timeout=300), f"front door: request {h.id} "
                  "never retired")
    finally:
        door.stop(drain=False, timeout=120)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K2": k2.launches, "K4": k4.launches, "K5": k5.launches,
                "K4-int8": k4.launches_q, "K5-int8": k5.launches_q}
    agg = eng.metrics.aggregate()
    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    _check_launches("front door", launches, cfg.num_layers, chunks, steps,
                    int8=False)
    check(victim.finish_reason == "cancelled"
          and len(victim.tokens) < victim.request.max_new_tokens,
          f"front door: running cancel ended {victim.finish_reason}")
    check(queued.finish_reason == "cancelled" and not queued.tokens,
          f"front door: queued cancel ended {queued.finish_reason} with "
          f"{len(queued.tokens)} tokens")
    check(late.finish_reason == "deadline_exceeded",
          f"front door: the late request ended {late.finish_reason}")
    diverged = 0
    for i, h in handles.items():
        if h is victim:
            continue
        check(h.finish_reason in ("length", "eos"),
              f"front door: request {i} ended {h.finish_reason}")
        if trace[i].get("greedy"):
            diverged += _same_as_phase5(torch, model, fp_reqs, i, h.tokens,
                                        f"front door {mix[i]}")
    for i, h in twin_h.items():
        check(h.tokens == handles[i].tokens or handles[i] is victim,
              f"front door: top-k 1 request {i} differs from its greedy "
              "twin")
        if handles[i] is victim:
            diverged += _same_as_phase5(torch, model, fp_reqs, i, h.tokens,
                                        "front door top-k 1 twin")
    report = {k: v for k, v in eng.audit().items() if v}
    check(not report and eng._alloc.free_count() == eng._alloc.capacity,
          f"front door: audit {report}, {eng._alloc.free_count()} of "
          f"{eng._alloc.capacity} blocks free")
    check(eng.executable_count() == 2
          and eng.telemetry.recompile_events() == 0,
          f"front door: {eng.executable_count()} argument signatures, "
          f"{eng.telemetry.recompile_events()} recompiles across the mix")
    dropped = eng.telemetry.registry.get(
        "serving_requests_dropped_total").snapshot()
    done = eng.telemetry.registry.get(
        "serving_requests_completed_total").snapshot()
    snap = eng.telemetry.profiler.snapshot()
    shares = ", ".join(
        f"{name} {ph['fraction_of_tick']:.4f}"
        for name, ph in sorted(snap["phases"].items(),
                               key=lambda kv: -kv[1]["seconds_total"]))
    print(f"front door: {len(handles) + len(twin_h) + 3} requests, "
          f"{chunks} prefill chunks, {steps} decode steps, launches "
          f"{launches}, dropped {dropped}, retired {done}, "
          f"{diverged} greedy near-ties against phase 5", flush=True)
    print(f"front door tick anatomy on {card} (host clock; {snap['ticks']}"
          f" ticks): share of the tick wall: {shares}", flush=True)
    print(f"front door on {card}: wall {wall:.2f} s, decode step p50 "
          f"{agg['decode_step_ms_p50']:.2f} ms (host clock)", flush=True)


def _snapshots_5k(torch, card, model, fp_reqs):
    """5k(b): a live greedy and a live sampled request of phase 5's trace
    as byte frames mid-flight on the card, restored on a second engine
    over the same weights (``swap_in``); a flipped payload byte restores
    ``corrupt_fallback``. Every continuation equals the uninterrupted
    run's tokens."""
    from paddle_tpu_torch.inference import Request, ServingEngine

    trace = _serving_trace(model.config.vocab_size)
    gi = next(i for i, kw in enumerate(trace) if kw.get("greedy"))
    si = next(i for i, kw in enumerate(trace) if not kw.get("greedy"))
    kw = dict(max_batch_slots=8, max_len=1024, block_size=16,
              prefill_chunk=128, seed=0, device="cuda",
              host_tier_blocks=128)
    src = ServingEngine(model, **kw)
    reqs = [src.submit(Request(**trace[i])) for i in (gi, si)]
    for _ in range(400):
        if all(len(r.tokens) >= 5 for r in reqs):
            break
        src.run(max_steps=1)
    check(all(5 <= len(r.tokens) < r.max_new_tokens for r in reqs),
          f"snapshots: requests at {[len(r.tokens) for r in reqs]} tokens")
    frames = [src.snapshot_request_bytes(r.id) for r in reqs]
    src.run()
    full = [list(r.tokens) for r in reqs]
    dst = ServingEngine(model, **kw)
    restored = [dst.restore_request(f) for f in frames]
    at = [len(r.tokens) for r in restored]
    dst.run()
    outcomes = [r._restore_outcome for r in restored]
    check(outcomes == ["swap_in", "swap_in"],
          f"snapshots: restore outcomes {outcomes}")
    check([r.tokens for r in restored] == full,
          "snapshots: a restored continuation differs from the "
          "uninterrupted run")
    bad = bytearray(frames[0])
    bad[-64] ^= 0xFF
    fb = ServingEngine(model, **kw)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fallback = fb.restore_request(bytes(bad))
    fb.run()
    check(fallback._restore_outcome == "corrupt_fallback",
          f"snapshots: a corrupt frame restored "
          f"{fallback._restore_outcome}")
    diverged = _same_greedy(torch, model, [reqs[0]], [fallback],
                            "corrupt fallback")
    for eng in (src, dst, fb):
        report = {k: v for k, v in eng.audit().items() if v}
        check(not report and eng._alloc.free_count() == eng._alloc.capacity
              and eng._host.free_count() == eng._host.capacity,
              f"snapshots: audit {report}")
    print(f"snapshots: frames of {[len(f) for f in frames]} bytes taken "
          f"at {at} tokens, restored {outcomes} token-exact; corrupt "
          f"payload -> corrupt_fallback, {diverged} near-ties", flush=True)


def _metric_lines(url, name):
    """``{label value: sample}`` of one metric family in a ``/metrics``
    scrape."""
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        m = re.match(name + r'\{\w+="([^"]+)"\} (\S+)$', line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


class _EngineProc:
    """One ``engine_proc`` serving process and a reader of its stdout."""

    def __init__(self, config, log_dir, name):
        import queue
        import threading

        self.name = name
        self.log = open(os.path.join(log_dir, f"engine_{name}.log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.inference.fleet."
             "engine_proc", "--config", json.dumps(config)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.log,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
        self.lines = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line.strip())
        self.lines.put(None)

    def expect(self, prefix, timeout):
        import queue

        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            try:
                line = self.lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if line is None:
                break
            if line.startswith(prefix + " "):
                return json.loads(line[len(prefix) + 1:])
        self.log.seek(0)
        fail(f"fleet: engine {self.name} printed no {prefix} line "
             f"(exit {self.proc.poll()}); its stderr ends:\n"
             f"{self.log.read()[-3000:]}")

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)
        self.log.close()


def _fleet_5k(torch, card, model, fp_reqs):
    """5k(c): two ``engine_proc`` processes on the card behind a
    ``FleetRouter``, phase 5's first 8 requests routed through them: the
    greedy one with the longest budget migrated mid-stream; the last
    greedy one submitted after the migration, and its engine killed
    (SIGKILL) under it mid-stream. Both are token-exact against phase 5,
    the shutdown drains and audits clean, and each process's own K2, K4
    and K5 launches are non-zero."""
    import dataclasses
    import signal
    import tempfile

    from paddle_tpu_torch.inference.fleet import EngineRef, FleetRouter

    cfg = model.config
    trace = _serving_trace(cfg.vocab_size)[:8]
    config = {"model": dataclasses.asdict(cfg), "model_seed": 0,
              "engine": dict(max_batch_slots=8, max_len=1024,
                             block_size=16, prefill_chunk=128, seed=0,
                             host_tier_blocks=128, device="cuda")}
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_5k_")
    procs = {}
    try:
        for name in ("A", "B"):
            procs[name] = _EngineProc(config, log_dir, name)
        urls = {n: p.expect("READY", 300) for n, p in procs.items()}
        router = FleetRouter(
            [EngineRef(n, u["ingest_url"], u["ops_url"])
             for n, u in urls.items()], seed=5, timeout=60.0,
            breaker_cooldown=30.0)
        greedy = [i for i, kw in enumerate(trace) if kw.get("greedy")]
        last = greedy[-1]

        def submit(i):
            kw = trace[i]
            return router.submit(
                kw["prompt"], max_new_tokens=kw["max_new_tokens"],
                sampling=({"greedy": True} if kw.get("greedy")
                          else {"temperature": 0.8, "top_p": 0.9}))

        hs = {i: submit(i) for i in range(len(trace)) if i != last}
        mi = max(greedy[:-1], key=lambda i: trace[i]["max_new_tokens"])
        mig = hs[mi]
        _wait_for(lambda: len(mig.tokens) >= 3 or mig.status != "running",
                  "fleet: migration candidate")
        check(mig.status == "running", "fleet: the migration candidate "
              "finished before its migration")
        src = mig.engine
        outcome = router.migrate(mig)
        check(outcome == "swap_in" and mig.engine != src,
              f"fleet: migration {src} -> {mig.engine}: {outcome}")
        victim = hs[last] = submit(last)
        _wait_for(lambda: victim.engine is not None,
                  "fleet: kill victim placement")
        dead = victim.engine
        _wait_for(lambda: len(victim.tokens) >= 2
                  or victim.status != "running", "fleet: kill victim")
        dead_launches = _metric_lines(urls[dead]["ops_url"],
                                      "kernel_launches")
        os.kill(urls[dead]["pid"], signal.SIGKILL)
        for h in hs.values():
            check(h.wait(timeout=300), f"fleet: request {h.fid} never "
                  "finished")
        report = router.shutdown(drain=True, timeout=120)
        alive = next(n for n in procs if n != dead)
        procs[alive].proc.stdin.close()
        exit_line = procs[alive].expect("EXIT", 120)
        check(procs[alive].proc.wait(timeout=120) == 0,
              f"fleet: engine {alive} exited "
              f"{procs[alive].proc.returncode}")
    finally:
        for p in procs.values():
            p.close()
    diverged = 0
    for i, h in sorted(hs.items()):
        check(h.status == "done" and h.finish_reason in ("length", "eos"),
              f"fleet: request {i} ended {h.status}/{h.finish_reason}")
        if i in greedy:
            diverged += _same_as_phase5(torch, model, fp_reqs, i, h.tokens,
                                        f"fleet request {i}")
    check(victim.resubmits + victim.migrations >= 1,
          "fleet: the kill victim never failed over")
    check(report["leaked_blocks"] == 0 and report["orphaned_pins"] == 0
          and report["unterminated_streams"] == 0
          and dead in report["unreachable_engines"],
          f"fleet: shutdown report {report}")
    for name, got in ((dead, dead_launches),
                      (alive, exit_line["launches"])):
        check(all(got.get(k, 0) > 0 for k in ("K2", "K4", "K5")),
              f"fleet: engine {name} launches {got}")
    print(f"fleet: 8 requests over 2 engine processes, {mig.fid} migrated "
          f"{src} -> {mig.engine} ({outcome}), {dead} killed under "
          f"request {victim.fid} (failed over to {victim.engine}), "
          f"launches {dead}: {dead_launches}, {alive}: "
          f"{exit_line['launches']}, {diverged} near-ties against phase 5; "
          f"shutdown {report}", flush=True)


def frontdoor_fleet_phase(torch, card, model, fp_reqs):
    t0 = time.perf_counter()
    _front_door_5k(torch, card, model, fp_reqs)
    _snapshots_5k(torch, card, model, fp_reqs)
    _fleet_5k(torch, card, model, fp_reqs)
    print(f"phase 5k on {card}: wall {time.perf_counter() - t0:.1f} s "
          "(host clock)", flush=True)


# ------------------------- 5l: adapters, grammars, score and embed
# multi-LoRA: AdapterPool(4, 16, 12, 768) with three adapters drawn by
# random_weights(seed, LORA_SCALE). At 0.02 (the reference's default)
# A@B is ~1e-3, a tenth of gpt2_small's weights, and moves few greedy
# tokens; at LORA_SCALE it is ~0.04, so most adapter requests' tokens
# move and the gate below sees a dropped or misrouted delta
LORA_RANK = 16
LORA_SCALE = 0.1
LORA_SEEDS = (101, 102, 103)
# score logprobs and embed hidden states against a full-sequence fp32
# forward of the plain model: the engine's chunks (K5 over the paged
# pool) and the no-cache forward sum in other orders, and a logprob
# carries its logsumexp's error over 50257 logits. On an H100 the worst
# over 5l's 8 prompts reads 3.8e-6 (logprob) and 4.6e-6 (hidden): the
# limits sit ~5x above
SCORE_TOL = 2e-5
EMBED_TOL = 2e-5
# the grammars of 5l(b): character grammars over the byte vocabulary
# (ids >= 256 decode to "", so only byte tokens are ever legal) and an
# allow-list of 64 ids past the bytes; EOS is GPT-2's end of text
EOS_5L = 50256
GRAMMARS_5L = (
    {"type": "regex", "pattern": "[a-z]{2,6}( [a-z]{2,6}){0,9}"},
    {"type": "json_object"},
    {"type": "json_schema", "schema": {
        "type": "object", "properties": {"id": {"type": "integer"},
                                         "ok": {"type": "boolean"}},
        "required": ["id"]}},
    {"type": "allowed_tokens", "tokens": list(range(1000, 1064))},
)


def _merged_model(torch, model, pool, name):
    """A copy of ``model`` with adapter ``name`` folded into its
    projections (W + A@B, the reference's ``merged_delta``): the
    ground truth an adapter request must reproduce."""
    from paddle_tpu_torch.models import GPTForCausalLM

    merged = GPTForCausalLM(model.config, device="cuda")
    merged.load_state_dict(model.state_dict())
    merged.eval()
    with torch.no_grad():
        for i, blk in enumerate(merged.gpt.h):
            for tgt, lin in (("qkv", blk.attn.qkv_proj),
                             ("out", blk.attn.out_proj),
                             ("fc_in", blk.mlp.fc_in),
                             ("fc_out", blk.mlp.fc_out)):
                lin.weight += torch.from_numpy(
                    pool.merged_delta(name, tgt, i)).to(lin.weight)
    return merged


def _lora_5l(torch, card, model, fp_reqs):
    """5l(a): phase 5's 16 requests, 4 on the base model and 4 on each of
    three adapters, through ``ServingEngine(adapter_pool=)``, plainly and
    with ``NgramDrafter(k=4)`` (K4 at s 5). Base requests equal phase
    5's tokens (bitwise without speculation, near-ties counted with
    it); each adapter request's greedy tokens equal a pool-less
    engine's over the model merged to W + A@B (near-ties counted); 2
    argument signatures, a clean audit with no adapter reference left,
    and launch counts from the run's own chunks and steps. Returns the
    plain run's aggregate."""
    from paddle_tpu_torch.inference import NgramDrafter
    from paddle_tpu_torch.inference.adapter_pool import AdapterPool

    cfg = model.config
    L = cfg.num_layers
    pool = AdapterPool(4, LORA_RANK, L, cfg.hidden_size)
    names = ("a0", "a1", "a2")
    for n, seed in zip(names, LORA_SEEDS):
        pool.register(n, pool.random_weights(seed=seed, scale=LORA_SCALE))
    trace = _serving_trace(cfg.vocab_size)
    which = [None] * 4 + [n for n in names for _ in range(4)]
    mix = [dict(kw, adapter=a) for kw, a in zip(trace, which)]
    runs = {}
    for what, spec in (("5l lora", None),
                       ("5l lora spec", NgramDrafter(k=4))):
        eng, reqs, agg, wall, launches = _serve(torch, model, mix,
                                                adapter_pool=pool, spec=spec)
        chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
        print(f"{what}: {int(agg['completed'])} requests, {chunks} prefill "
              f"chunks, {steps} {'verify' if spec else 'decode'} steps, "
              f"{int(agg['preemptions'])} preemptions, launches {launches}",
              flush=True)
        _check_launches(what, launches, L, chunks, steps, int8=False)
        check(eng.executable_count() == 2, f"{what}: "
              f"{eng.executable_count()} argument signatures, want 2")
        audit = eng.audit()
        check(not any(audit.values()), f"{what}: audit {audit}")
        check(all(pool.refcount(n) == 0 for n in names),
              f"{what}: adapter references left")
        if spec is None:
            for i in range(4):
                check(reqs[i].tokens == fp_reqs[i].tokens,
                      f"{what}: base request {i} differs from phase 5's")
        else:
            nt = _same_greedy(torch, model, fp_reqs[:4], reqs[:4], what)
            print(f"{what}: base requests against phase 5: {nt} near-tie "
                  "divergences", flush=True)
        runs[what] = (reqs, agg, wall)
    reqs = runs["5l lora"][0]
    greedy = [i for i in range(4, 16) if reqs[i].greedy]
    moved = sum(reqs[i].tokens != fp_reqs[i].tokens for i in greedy)
    print(f"5l lora: {moved} of {len(greedy)} greedy adapter requests "
          f"differ from the base model's tokens (scale {LORA_SCALE})",
          flush=True)
    check(2 * moved >= len(greedy), f"5l lora: only {moved} of "
          f"{len(greedy)} adapter requests moved off the base tokens")
    for n in names:
        merged = _merged_model(torch, model, pool, n)
        idx = [i for i, a in enumerate(which) if a == n]
        _, ref, _, _, _ = _serve(torch, merged, [trace[i] for i in idx])
        for what, (got, _, _) in runs.items():
            nt = _same_greedy(torch, merged, ref, [got[i] for i in idx],
                              f"{what} {n}")
            print(f"{what}: adapter {n} against the merged-weights model: "
                  f"{nt} near-tie divergences", flush=True)
        del merged
        torch.cuda.empty_cache()
    return runs["5l lora"][1]


def _masked_check(torch, model, req, grammar, what):
    """Every token of ``req`` legal under ``grammar`` (a compiled
    grammar: EOS only where it accepts), and for a greedy request each
    token the argmax of a teacher-forced no-cache forward masked by the
    automaton's row, but at a near-tie (top-2 legal gap < 1e-3).
    Returns (tokens checked, near-ties)."""
    from paddle_tpu_torch.inference.constrain import (ConstraintState,
                                                      token_in_row)

    cs = ConstraintState(grammar)
    rows = []
    for t in req.tokens:
        row = cs.mask_row()
        check(token_in_row(row, t), f"{what}: request {req.id} emitted "
              f"illegal token {t} at {len(rows)}")
        rows.append(row)
        if t == EOS_5L:
            check(cs.accepting(), f"{what}: request {req.id} ended "
                  "outside an accepting state")
            break
        cs.advance(t)
    if not req.greedy or not req.tokens:
        return len(rows), 0
    near = 0
    with torch.inference_mode():
        ids = torch.tensor([list(req.prompt) + req.tokens[:-1]],
                           device="cuda")
        logits = model(ids)[0, len(req.prompt) - 1:].float()
        V = logits.shape[-1]
        idx = torch.arange(V, device="cuda")
        masks = torch.from_numpy(np.stack(rows)).to("cuda")
        bit = (masks[:, idx // 32] >> (idx % 32).to(torch.int32)) & 1
        lg = logits[:len(rows)].masked_fill(bit == 0, float("-inf"))
        top2 = torch.topk(lg, 2, dim=-1).values
        arg = lg.argmax(-1).cpu().numpy()
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    for pos, (a, t, g) in enumerate(zip(arg, req.tokens, gap)):
        if a != t:
            check(g < 1e-3, f"{what}: request {req.id} position {pos}: "
                  f"emitted {t}, masked argmax {a}, top-2 gap {g}")
            near += 1
    return len(rows), near


def _accepted_text_ok(req, rf) -> bool:
    """An accepting finish (EOS) of ``req`` matches its grammar's own
    meaning: the regex; for ``json_object`` any JSON value (the
    reference's grammar, ``constrain.py`` ``from_response_format``); for
    the schema an object with an integer ``id`` and a boolean ``ok``;
    the allow-list."""
    body = req.tokens[:-1]
    if rf["type"] == "allowed_tokens":
        return set(body) <= set(rf["tokens"])
    text = bytes(body).decode("latin-1")
    if rf["type"] == "regex":
        return re.fullmatch(rf["pattern"], text) is not None
    try:
        obj = json.loads(text)
    except ValueError:
        return False
    if rf["type"] == "json_object":
        return True
    return isinstance(obj, dict) and type(obj.get("id")) is int \
        and type(obj.get("ok")) is bool


def _constraints_5l(torch, card, model, fp_reqs):
    """5l(b): phase 5's first 8 prompts under a regex, ``json_object``, a
    ``json_schema`` and an allow-list, greedy (the first 4) and sampled,
    plus a regex planted to dead-end (``"ab"`` without EOS). Every token
    legal, every accepting finish matching its grammar, greedy tokens the
    masked argmax of a no-cache forward (near-ties counted), the dead end
    retired and counted; the 4 greedy ones again under
    ``NgramDrafter(k=4)``, the same checks; then phase 5's trace on the
    same engine with no constraint, to phase 5's greedy tokens."""
    from paddle_tpu_torch.inference import NgramDrafter
    from paddle_tpu_torch.inference.constrain import from_response_format

    cfg = model.config
    L = cfg.num_layers
    trace = _serving_trace(cfg.vocab_size)
    con = []
    for i in range(8):
        kw = dict(prompt=trace[i]["prompt"],
                  max_new_tokens=trace[i]["max_new_tokens"],
                  response_format=GRAMMARS_5L[i % 4], eos_id=EOS_5L)
        kw.update(greedy=True) if i < 4 else kw.update(
            temperature=0.8, top_p=0.9, seed=i)
        con.append(kw)
    planted = dict(prompt=trace[8]["prompt"], max_new_tokens=8, greedy=True,
                   response_format={"type": "regex", "pattern": "ab"})
    reasons = ("length", "eos", "constraint_dead_end")
    eng, reqs, agg, wall, launches = _serve(torch, model, con + [planted],
                                            reasons=reasons)
    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    _check_launches("5l constrained", launches, L, chunks, steps, int8=False)
    grammars = [from_response_format(kw["response_format"]).compile(
        cfg.vocab_size, kw.get("eos_id")) for kw in con]
    checked = near = accepted = 0
    for r, g, kw in zip(reqs, grammars, con):
        c, n = _masked_check(torch, model, r, g, "5l constrained")
        checked, near = checked + c, near + n
        if r.finish_reason == "eos":
            accepted += 1
            check(_accepted_text_ok(r, kw["response_format"]),
                  f"5l constrained: request {r.id} accepted "
                  f"{r.tokens} outside {kw['response_format']}")
    dead = reqs[-1]
    check(dead.finish_reason == "constraint_dead_end"
          and dead.tokens == [97, 98], f"5l constrained: the planted dead "
          f"end ended {dead.finish_reason} with {dead.tokens}")
    check(agg["constraint_dead_ends"] == 1.0 and eng.telemetry.registry.get(
        "serving_constraint_dead_ends_total").value == 1.0,
        "5l constrained: the dead end was not counted once")
    print(f"5l constrained: {checked} tokens legal, {near} masked near-tie "
          f"mismatches, {accepted} accepting finishes, "
          f"{sum(r.finish_reason == 'length' for r in reqs)} at length, the "
          f"dead end retired and counted; constrained_tokens "
          f"{int(agg['constrained_tokens'])}, mask_builds "
          f"{int(agg['mask_builds'])}, in-window fraction "
          f"{agg['mask_in_window_fraction']:.3f}; launches {launches}",
          flush=True)
    # phase 5's trace, unconstrained, on the same engine
    from paddle_tpu_torch.inference import Request
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    plain = [eng.submit(Request(**kw)) for kw in trace]
    for m in (k2, k4, k5):
        m.reset_launches()
    agg2 = eng.run().aggregate()
    torch.cuda.synchronize()
    _check_launches("5l constrained, then plain", {
        "K2": k2.launches, "K4": k4.launches, "K5": k5.launches,
        "K4-int8": k4.launches_q, "K5-int8": k5.launches_q}, L,
        int(agg2["prefill_chunks"]), int(agg2["decode_steps"]), int8=False)
    nt = _same_greedy(torch, model, fp_reqs, plain, "5l constrained, then "
                      "plain")
    check(eng.executable_count() == 2, f"5l constrained: "
          f"{eng.executable_count()} argument signatures, want 2")
    check((eng.engine.vocab_masks == -1).all(),
          "5l constrained: a retired lane kept its mask row")
    print(f"5l constrained, then phase 5's trace on the same engine: "
          f"greedy tokens equal phase 5's ({nt} near-tie divergences), "
          "2 argument signatures", flush=True)
    # the greedy four under k = 4 speculation
    eng, sreqs, sagg, _, slaunches = _serve(torch, model, con[:4],
                                            reasons=reasons,
                                            spec=NgramDrafter(k=4))
    _check_launches("5l constrained spec", slaunches, L,
                    int(sagg["prefill_chunks"]), int(sagg["decode_steps"]),
                    int8=False)
    near_s = 0
    for r, g in zip(sreqs, grammars):
        near_s += _masked_check(torch, model, r, g,
                                "5l constrained spec")[1]
    same = sum(a.tokens == b.tokens for a, b in zip(reqs[:4], sreqs))
    print(f"5l constrained spec (k = 4): {int(sagg['spec_verify_steps'])} "
          f"verify steps, {same} of 4 equal the plain run, {near_s} masked "
          f"near-tie mismatches; launches {slaunches}", flush=True)


def _post_json(url, payload):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _batch_5l(torch, card, model, fp_reqs):
    """5l(c): 8 score and embed requests (phase 5's first 8 prompts)
    alone and then mixed with 8 generate requests (its last 8). Score
    logprobs against a full-sequence forward's log-softmax at the next
    tokens (SCORE_TOL), embeddings against its final hidden state
    (EMBED_TOL); alone they dispatch no decode step (K4 0); mixed they
    give the same numbers bitwise and the generate requests phase 5's
    greedy tokens; ``/v1/score`` and ``/v1/embed`` answer 200 with them."""
    from paddle_tpu_torch.inference.frontend import FrontDoor

    cfg = model.config
    L = cfg.num_layers
    trace = _serving_trace(cfg.vocab_size)
    batch = [dict(prompt=trace[i]["prompt"],
                  kind="score" if i % 2 == 0 else "embed") for i in range(8)]
    eng, reqs, agg, wall, launches = _serve(torch, model, batch,
                                            reasons=("complete",))
    chunks = int(agg["prefill_chunks"])
    check(agg.get("decode_steps", 0.0) == 0.0,
          f"5l batch: {agg.get('decode_steps')} decode steps dispatched")
    _check_launches("5l batch", launches, L, chunks, 0, int8=False)
    worst = {"score": 0.0, "embed": 0.0}
    with torch.inference_mode():
        for r in reqs:
            ids = torch.tensor([list(r.prompt)], device="cuda")
            logits, hidden = model(ids, output_hidden=True)
            if r.kind == "score":
                lp = torch.log_softmax(logits[0, :-1].float(), -1)
                want = lp.gather(-1, ids[0, 1:, None])[:, 0].cpu().numpy()
                got = np.asarray(r.logprobs)
                check(got.shape == want.shape, f"5l batch: request {r.id} "
                      f"has {got.shape} logprobs, want {want.shape}")
            else:
                want = hidden[0, -1].float().cpu().numpy()
                got = r.embedding
            worst[r.kind] = max(worst[r.kind],
                                float(np.abs(got - want).max()))
    check(worst["score"] < SCORE_TOL and worst["embed"] < EMBED_TOL,
          f"5l batch: worst errors {worst} past {SCORE_TOL}/{EMBED_TOL}")
    print(f"5l batch: {len(reqs)} score/embed requests, {chunks} chunks, 0 "
          f"decode steps, launches {launches}; worst |logprob - full "
          f"forward| {worst['score']:.3e} (limit {SCORE_TOL}), worst "
          f"|embedding - full forward| {worst['embed']:.3e} (limit "
          f"{EMBED_TOL})", flush=True)
    mix = batch + trace[8:]
    _, mreqs, magg, _, mlaunches = _serve(torch, model, mix,
                                          reasons=("length", "eos",
                                                   "complete"))
    _check_launches("5l batch mix", mlaunches, L,
                    int(magg["prefill_chunks"]), int(magg["decode_steps"]),
                    int8=False)
    for a, b in zip(reqs, mreqs[:8]):
        check(a.logprobs == b.logprobs and (a.embedding is None or
                                            np.array_equal(a.embedding,
                                                           b.embedding)),
              f"5l batch mix: request {b.id}'s numbers moved with its "
              "neighbours")
    nt = _same_greedy(torch, model, fp_reqs[8:], mreqs[8:], "5l batch mix")
    print(f"5l batch mix: 8 batch + 8 generate requests, numbers equal "
          f"the batch-only run bitwise, generate tokens equal phase 5's "
          f"({nt} near-tie divergences), launches {mlaunches}", flush=True)
    door = FrontDoor(model, ingest_port=0, max_batch_slots=8, max_len=1024,
                     block_size=16, prefill_chunk=128, seed=0,
                     device="cuda").start()
    try:
        diffs = []
        for r in reqs[:2]:
            code, body = _post_json(f"{door.ingest.url}/v1/{r.kind}",
                                    {"prompt": list(r.prompt)})
            check(code == 200, f"5l ingest: /v1/{r.kind} answered {code}")
            got = body["logprobs"] if r.kind == "score" else \
                body["embedding"]
            want = r.logprobs if r.kind == "score" else r.embedding
            diffs.append(float(np.abs(np.asarray(got) -
                                      np.asarray(want)).max()))
        check(max(diffs) <= 1e-6, f"5l ingest: answers differ by {diffs}")
    finally:
        door.stop(drain=False)
    print(f"5l ingest: /v1/score and /v1/embed answered 200, max |diff| "
          f"from the engine's {max(diffs):.1e}", flush=True)


def _migrate_5l(torch, card, model):
    """5l(d): phase 5's first two greedy requests, one on adapter a0 and
    one under the allow-list, run uninterrupted on one engine; then the
    same pair on a second engine, migrated out mid-flight
    (``migrate_out_request``) and restored on a third whose own pool
    holds a0 (``swap_in``). The snapshot carries the adapter and the
    grammar: the adapter request gives the uninterrupted tokens (a
    divergence only at a near-tie of the merged model), the constrained
    one only legal tokens, each its masked argmax; audits clean, no
    adapter reference left, and K2, K4 and K5 launched by the restored
    run."""
    from paddle_tpu_torch.inference import Request, ServingEngine
    from paddle_tpu_torch.inference.adapter_pool import AdapterPool
    from paddle_tpu_torch.inference.constrain import from_response_format
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    cfg = model.config
    greedy = [kw for kw in _serving_trace(cfg.vocab_size)
              if kw.get("greedy")][:2]
    rf = GRAMMARS_5L[3]
    mix = [dict(greedy[0], adapter="a0"),
           dict(greedy[1], response_format=rf, eos_id=EOS_5L)]
    pools = []
    for _ in range(2):
        p = AdapterPool(4, LORA_RANK, cfg.num_layers, cfg.hidden_size)
        p.register("a0", p.random_weights(seed=LORA_SEEDS[0],
                                          scale=LORA_SCALE))
        pools.append(p)
    kw = dict(max_batch_slots=8, max_len=1024, block_size=16,
              prefill_chunk=128, seed=0, device="cuda",
              host_tier_blocks=128)
    whole = ServingEngine(model, adapter_pool=pools[0], **kw)
    full = [whole.submit(Request(**m)) for m in mix]
    whole.run()
    src = ServingEngine(model, adapter_pool=pools[0], **kw)
    reqs = [src.submit(Request(**m)) for m in mix]
    for _ in range(400):
        if all(len(r.tokens) >= 5 for r in reqs):
            break
        src.run(max_steps=1)
    at = [len(r.tokens) for r in reqs]
    check(all(5 <= n < r.max_new_tokens for n, r in zip(at, reqs)),
          f"5l migrate: requests at {at} tokens")
    frames = [src.migrate_out_request(r.id) for r in reqs]
    dst = ServingEngine(model, adapter_pool=pools[1], **kw)
    restored = [dst.restore_request(f) for f in frames]
    torch.cuda.synchronize()
    for m in (k2, k4, k5):
        m.reset_launches()
    dst.run()
    torch.cuda.synchronize()
    launches = {"K2": k2.launches, "K4": k4.launches, "K5": k5.launches}
    outcomes = [r._restore_outcome for r in restored]
    check(outcomes == ["swap_in", "swap_in"],
          f"5l migrate: restore outcomes {outcomes}")
    check(all(v > 0 for v in launches.values()),
          f"5l migrate: the restored run launched {launches}")
    check(restored[0].adapter == "a0" and restored[1].response_format == rf,
          "5l migrate: the restored requests lost their adapter or grammar")
    merged = _merged_model(torch, model, pools[1], "a0")
    nt = _same_greedy(torch, merged, [full[0]], [restored[0]],
                      "5l migrate adapter")
    del merged
    torch.cuda.empty_cache()
    grammar = from_response_format(rf).compile(cfg.vocab_size, EOS_5L)
    checked, near = _masked_check(torch, model, restored[1], grammar,
                                  "5l migrate constrained")
    for eng in (whole, src, dst):
        report = {k: v for k, v in eng.audit().items() if v}
        check(not report and eng._host.free_count() == eng._host.capacity,
              f"5l migrate: audit {report}")
    check(all(p.refcount("a0") == 0 for p in pools),
          "5l migrate: adapter references left")
    exact = [r.tokens == f.tokens for r, f in zip(restored, full)]
    print(f"5l migrate: an adapter and a constrained request moved at {at} "
          f"tokens, restored {outcomes}; equal to the uninterrupted run "
          f"{exact}, {nt} adapter near-ties against the merged model, "
          f"{checked} constrained tokens legal with {near} masked "
          f"near-ties; launches {launches}", flush=True)


def lora_constrained_phase(torch, card, model, fp_reqs, fp_agg):
    t0 = time.perf_counter()
    agg = _lora_5l(torch, card, model, fp_reqs)
    _constraints_5l(torch, card, model, fp_reqs)
    _batch_5l(torch, card, model, fp_reqs)
    _migrate_5l(torch, card, model)
    print(f"phase 5l on {card}: wall {time.perf_counter() - t0:.1f} s; "
          f"5l(a)'s decode step p50 {agg['decode_step_ms_p50']:.2f} ms "
          f"beside phase 5's {fp_agg['decode_step_ms_p50']:.2f} ms (host "
          "clock, not gated)", flush=True)


# -- phase 5m: adaptive serving -----------------------------------------------

def _adaptive_counts(eng):
    """(decisions by controller, adapt flight events, absorbed errors)."""
    reg = eng.telemetry.registry
    return (reg.get("serving_adaptive_decisions_total").snapshot(),
            eng.telemetry.recorder.events(kind="adapt"),
            reg.get("serving_adaptive_errors_total").value)


def _forced_budget():
    """A controller in the manner of the reference's ``_ForceChunk``
    (``tests/test_adaptive.py``): the chunk budget 1 -> 2 -> 4, one step
    a window, then held."""
    from paddle_tpu_torch.inference.adaptive import AdaptiveController

    class _ForceBudget(AdaptiveController):
        name = "chunk_budget"
        unit = "chunks/tick"

        def __init__(self):
            super().__init__(dwell=1)

        def value(self, engine):
            return engine._chunks_per_tick

        def propose(self, engine, window):
            self.last_signal = {"forced": True,
                                "backlog": window["prefill_backlog"]}
            return {1: 2, 2: 4}.get(engine._chunks_per_tick)

        def apply(self, engine, value):
            engine._chunks_per_tick = int(value)

    return _ForceBudget()


def _controllers_line(suite, eng):
    return "; ".join(
        f"{name}: value {st['value']} {st['unit']}, {st['decisions']} "
        f"decisions, last {st['last']}"
        for name, st in suite.state(eng)["controllers"].items())


def adaptive_phase(torch, card, model, fp_reqs, fp_agg, fp_launches,
                   spec_reqs, tier_reqs):
    """Phase 5m: the adaptive controllers on phase 5's fp32 model. (a) A
    forced chunk budget (1 -> 2 -> 4) on phase 5's trace: greedy tokens
    phase 5's (near-ties counted), K5 launches phase 5's exactly, K4 and
    K2 exact for the run's own steps, 2 counted decisions and 2 ``adapt``
    flight events, no absorbed error. (b) ``AdaptiveSuite()`` at its
    defaults on the same trace: tokens as in (a), each controller's
    decisions and value, and the wall, TTFT p50 and decode step p50
    beside phase 5's (host clock; not gated). (c) 5d's ``NgramDrafter(k=
    4)`` trace at a forced ``k_eff`` of 2 and then under a
    ``DraftLenController``: tokens 5d's, K4 at L a verify step (the
    verify keeps k + 1 = 5 rows), no recompile. (d) 5i's poisoned
    starved pool with a host tier under a ``SwapMinController``: tokens
    5i's, the copy meters above 0 and equal to the tier's counts, the
    copy's seconds a block by CUDA events and by the host clock. Returns
    the phase's K2, K4 and K5 launches."""
    from paddle_tpu_torch.inference import NgramDrafter
    from paddle_tpu_torch.inference.adaptive import (AdaptiveSuite,
                                                     DraftLenController,
                                                     SwapMinController)

    cfg = model.config
    L = cfg.num_layers
    trace = _serving_trace(cfg.vocab_size)
    total = {"K2": 0, "K4": 0, "K5": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    # (a) the forced budget; interval 8 leaves the warm-up request's few
    # ticks without a window
    forced = AdaptiveSuite([_forced_budget()], interval=8)
    eng, reqs, agg, wall, launches = _serve(torch, model, trace,
                                            adaptive=forced)
    add(launches)
    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    dec, events, errs = _adaptive_counts(eng)
    print(f"5m(a) forced budget: {chunks} prefill chunks, {steps} decode "
          f"steps (phase 5: {int(fp_agg['prefill_chunks'])}, "
          f"{int(fp_agg['decode_steps'])}), {eng._ticks_total} ticks, "
          f"budget {eng._chunks_per_tick}, decisions {dec}, adapt events "
          f"{[(e['old'], e['new']) for e in events]}, errors {errs}, "
          f"launches {launches}", flush=True)
    _check_launches("5m(a)", launches, L, chunks, steps, int8=False)
    check(launches["K5"] == fp_launches["K5"],
          f"5m(a): K5 {launches['K5']} != phase 5's {fp_launches['K5']}")
    check(dec == {"chunk_budget": 2.0} and len(events) == 2 and errs == 0
          and [(e["old"], e["new"]) for e in events] == [(1, 2), (2, 4)]
          and eng._chunks_per_tick == 4,
          f"5m(a): decisions {dec}, events {events}, errors {errs}")
    n_a = _same_greedy(torch, model, fp_reqs, reqs, "5m(a)")
    print(f"5m(a): greedy tokens phase 5's but at {n_a} near-tie "
          "divergences; " + _perf_line("5m(a)", card, agg, wall), flush=True)

    # (b) the default suite
    suite = AdaptiveSuite()
    eng, reqs, agg, wall, launches = _serve(torch, model, trace,
                                            adaptive=suite)
    add(launches)
    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    _check_launches("5m(b)", launches, L, chunks, steps, int8=False)
    dec, events, errs = _adaptive_counts(eng)
    check(errs == 0 and len(events) == suite.decisions_total,
          f"5m(b): errors {errs}, {len(events)} events for "
          f"{suite.decisions_total} decisions")
    n_b = _same_greedy(torch, model, fp_reqs, reqs, "5m(b)")
    sig = suite.controllers[0].last_signal
    print(f"5m(b) AdaptiveSuite() defaults: {_controllers_line(suite, eng)}"
          f"; the chunk budget's last signal {sig}; {chunks} chunks, "
          f"{steps} steps, {eng._ticks_total} ticks; greedy tokens phase "
          f"5's but at {n_b} near-tie divergences", flush=True)
    print(f"5m(b) on {card} (host clock, not gated): wall {wall:.3f} s, "
          f"TTFT p50 {agg['ttft_p50_s'] * 1e3:.1f} ms, decode step p50 "
          f"{agg['decode_step_ms_p50']:.2f} ms (phase 5: TTFT p50 "
          f"{fp_agg['ttft_p50_s'] * 1e3:.1f} ms, decode step p50 "
          f"{fp_agg['decode_step_ms_p50']:.2f} ms)", flush=True)

    # (c) speculation: a forced k_eff, then the accept signal
    def force_k2(e):
        e._k_eff = 2
        e.spec.set_draft_len(2)

    for what, kw in (("5m(c) k_eff 2", dict(prepare=force_k2)),
                     ("5m(c) DraftLenController",
                      dict(adaptive=AdaptiveSuite([DraftLenController()])))):
        eng, reqs, agg, wall, launches = _serve(
            torch, model, trace, spec=NgramDrafter(k=4), **kw)
        add(launches)
        chunks, steps = int(agg["prefill_chunks"]), \
            int(agg["spec_verify_steps"])
        _check_launches(what, launches, L, chunks, steps, int8=False)
        check(eng.engine.k == 4 and eng.telemetry.recompile_events() == 0,
              f"{what}: verify k {eng.engine.k}, "
              f"{eng.telemetry.recompile_events()} recompiles")
        if "prepare" in kw:
            check(eng._k_eff == 2, f"{what}: k_eff {eng._k_eff}")
        n_c = _same_greedy(torch, model, spec_reqs, reqs, what)
        print(f"{what}: k_eff {eng._k_eff}, drafter {eng.spec.k_eff}, "
              f"{chunks} chunks, {steps} verify steps, {_spec_keys(agg)}, "
              f"launches {launches}; greedy tokens 5d's but at {n_c} "
              f"near-tie divergences", flush=True)

    # (d) the host tier under the swap controller
    ctrl = SwapMinController()
    eng, reqs, agg, wall, launches = _serve(
        torch, model, trace, poison=True, num_blocks=TIER_POOL,
        host_tier_blocks=TIER_POOL,
        adaptive=AdaptiveSuite([ctrl], interval=4))
    add(launches)
    chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
    _check_launches("5m(d)", launches, L, chunks, steps, int8=False)
    st = eng.host_tier_state()
    blocks, secs, host = (eng._swap_cost_blocks, eng._swap_cost_s,
                          eng._swap_cost_host_s)
    check(blocks > 0 and secs > 0 and blocks == st["spills"] + st["swap_ins"],
          f"5m(d): meters {blocks} blocks, {secs} s; tier {st}")
    n_d = _same_greedy(torch, model, tier_reqs, reqs, "5m(d)")
    print(f"5m(d) swap controller: swap_min {eng._swap_min} tokens, "
          f"{ctrl.decisions} decisions, last signal {ctrl.last_signal}; "
          f"tier spills {st['spills']} + swap-ins {st['swap_ins']} = "
          f"{blocks} blocks metered; copy seconds a block {secs / blocks:.3e}"
          f" (CUDA events) vs {host / blocks:.3e} (host clock) on {card}; "
          f"greedy tokens 5i's but at {n_d} near-tie divergences", flush=True)
    return total


def training_phase(torch, card):
    """``bench.py``'s training run on the port: returns the launch counts
    of the 10 timed steps and its perf (tokens/s, step p50, peak GiB)."""
    from paddle_tpu_torch.distributed import ShardedTrainer
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt2_small()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    batch, seq, warm, steps = 16, 1024, 2, 10
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    ids_np = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                              (batch, seq))
    ids = torch.from_numpy(ids_np).cuda()

    # fp32 (amp off) loss of the first 2 rows on the card, through the
    # kernels, against the same weights on the CPU through the plain
    # versions; both sides fp32 with no TF32, differing in summation order
    cpu = GPTForCausalLM(cfg, device="cpu", seed=0)
    cpu.set_state_dict({n: t.detach().cpu().numpy()
                        for n, t in model.state_dict().items()})
    with torch.no_grad():
        card_loss = float(model(ids[:2], ids[:2]))
        cpu_loss = float(cpu(ids[:2].cpu(), ids[:2].cpu()))
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"fp32 2-row loss: card {card_loss!r}, cpu {cpu_loss!r}, "
          f"relative difference {rel:.3g} (limit 1e-4)", flush=True)
    check(rel <= 1e-4, f"card fp32 loss {card_loss} != cpu {cpu_loss}")
    del cpu

    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    trainer = ShardedTrainer(model, opt, None, amp=True)
    losses = [trainer.train_step(ids, ids) for _ in range(warm)]
    torch.cuda.synchronize()
    for m in (fa, k2):
        m.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    for start, end in ev:
        start.record()
        losses.append(trainer.train_step(ids, ids))
        end.record()
    torch.cuda.synchronize()
    launches = {"K1": fa.launches["fwd"], "K3a": fa.launches["bwd_fused"],
                "K3b-dkv": fa.launches["bwd_dkv"],
                "K3b-dq": fa.launches["bwd_dq"], "K2": k2.launches}
    step_ms = [s.elapsed_time(e) for s, e in ev]
    total_ms = ev[0][0].elapsed_time(ev[-1][1])
    vals = [float(x) for x in losses]
    print(f"training losses: {vals}", flush=True)
    check(all(np.isfinite(vals)), "non-finite training loss")
    check(vals[-1] < vals[0], f"loss did not fall: {vals[0]} -> {vals[-1]}")
    L = cfg.num_layers
    want = {"K1": L * steps, "K3a": L * steps, "K3b-dkv": 0, "K3b-dq": 0,
            "K2": (2 * L + 1) * steps}
    check(launches == want, f"training launch counts {launches} != {want} "
          f"for {steps} steps")
    tokens_per_s = batch * seq * steps / (total_ms / 1e3)
    mfu = tokens_per_s * 6 * cfg.num_params() / PEAK_FLOPS["bfloat16"]
    perf = {"tokens_per_s": tokens_per_s,
            "step_p50_ms": float(np.median(step_ms)),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"training on {card}: {tokens_per_s:.1f} tokens/s, step p50 "
          f"{perf['step_p50_ms']:.2f} ms (min {min(step_ms):.2f}, max "
          f"{max(step_ms):.2f}), MFU {mfu:.4f} (6 x {cfg.num_params()} "
          f"params / 989 TFLOP/s), peak memory {perf['peak_gib']:.2f} GiB, "
          f"launches over {steps} steps {launches}", flush=True)
    _profile_step(torch, lambda: trainer.train_step(ids, ids),
                  perf["step_p50_ms"])
    return launches, perf


def _schedule():
    """Phase 6b's learning rate: 3 warm-up steps to 1e-4, then a cosine
    over 12 (a fresh one replays the rates on the host)."""
    from paddle_tpu_torch.optimizer import lr

    return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=12), 3, 0.0,
                           1e-4)


def _snapshot(torch, model, opt):
    """Copies of every parameter and every optimizer slot, on the card."""
    params = [p.detach().clone() for p in model.parameters()]
    states = [{k: v.clone() for k, v in opt._accumulators[id(p)].items()}
              for p in model.parameters()]
    return params, states


def _unchanged(torch, model, opt, snap) -> bool:
    params, states = snap
    return all(torch.equal(a, p.detach())
               for a, p in zip(params, model.parameters())) and all(
        torch.equal(v, opt._accumulators[id(p)][k])
        for st, p in zip(states, model.parameters()) for k, v in st.items())


def training_fp16_phase(torch, card, base):
    """6b: the loop a user writes, in fp16. ``gpt2_small`` at full width
    and depth with per-block recompute, batch 16 x 1024, both dropouts 0
    (so the gate admits flash), ``auto_cast(dtype="float16")``,
    ``GradScaler``, and AdamW on a warm-up + cosine schedule with a
    global-norm clip; 2 warm-up and 10 timed steps, then one planted step
    whose loss is multiplied by inf. Returns the launch counts of the
    timed steps; ``base`` is phase 6's perf, printed beside."""
    from paddle_tpu_torch.amp import GradScaler, auto_cast
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt2_small()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    cfg.recompute_granularity = "full"
    batch, seq, warm, steps = 16, 1024, 2, 10
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()
    sched, replay = _schedule(), _schedule()
    opt = AdamW(sched, parameters=model.parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    # one non-finite step halves the scale (the default waits for two)
    scaler = GradScaler(init_loss_scaling=2.0 ** 15, incr_every_n_steps=4,
                        decr_every_n_nan_or_inf=1)

    def step(plant=False):
        check(opt.get_lr() == replay(), f"6b: learning rate {opt.get_lr()!r}"
              f" != the schedule replayed on the host {replay()!r}")
        with auto_cast(dtype="float16"):
            loss = model(ids, ids)
        if plant:
            loss = loss * float("inf")
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        sched.step()
        replay.step()
        return loss.detach()

    losses = [step() for _ in range(warm)]
    torch.cuda.synchronize()
    for m in (fa, k2):
        m.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    for start, end in ev:
        start.record()
        losses.append(step())
        end.record()
    torch.cuda.synchronize()
    launches = {"K1": fa.launches["fwd"], "K3a": fa.launches["bwd_fused"],
                "K3b-dkv": fa.launches["bwd_dkv"],
                "K3b-dq": fa.launches["bwd_dq"], "K2": k2.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [s.elapsed_time(e) for s, e in ev]
    total_ms = ev[0][0].elapsed_time(ev[-1][1])
    vals = [float(x) for x in losses]
    print(f"6b fp16 losses: {vals}; loss scale {scaler.get_loss_scaling()},"
          f" skipped {scaler.num_skipped_steps}", flush=True)
    check(all(np.isfinite(vals)), "6b: non-finite fp16 training loss")
    check(vals[-1] < vals[0], f"6b: loss did not fall: {vals[0]} -> "
          f"{vals[-1]}")
    L = cfg.num_layers
    # per step: K1 in each block's forward and again in its replay, K3a
    # once; K2 twice a block forward and replay, and ln_f once
    want = {"K1": 2 * L * steps, "K3a": L * steps, "K3b-dkv": 0,
            "K3b-dq": 0, "K2": (4 * L + 1) * steps}
    check(launches == want, f"6b: launch counts {launches} != {want} for "
          f"{steps} steps")
    # the planted step: skipped, nothing moved, the scale halved
    snap = _snapshot(torch, model, opt)
    scale = scaler.get_loss_scaling()
    skipped = scaler.num_skipped_steps
    step(plant=True)
    torch.cuda.synchronize()
    check(scaler.num_skipped_steps == skipped + 1 == 1,
          f"6b: skipped steps {scaler.num_skipped_steps}, expected the "
          "planted one only")
    check(scaler.get_loss_scaling() == scale / 2, f"6b: loss scale "
          f"{scaler.get_loss_scaling()} after the planted step, expected "
          f"{scale / 2}")
    check(_unchanged(torch, model, opt, snap), "6b: the planted inf step "
          "moved a parameter or an optimizer slot")
    del snap
    tokens_per_s = batch * seq * steps / (total_ms / 1e3)
    print(f"6b fp16 + recompute on {card}: {tokens_per_s:.1f} tokens/s "
          f"(phase 6 {base['tokens_per_s']:.1f}), step p50 "
          f"{float(np.median(step_ms)):.2f} ms (phase 6 "
          f"{base['step_p50_ms']:.2f}), peak memory {peak:.2f} GiB (phase 6 "
          f"{base['peak_gib']:.2f}), launches over {steps} steps "
          f"{launches}; the planted inf step skipped with parameters and "
          f"AdamW state bitwise unchanged, scale {scale} -> "
          f"{scaler.get_loss_scaling()}", flush=True)
    return launches


def training_defaults_phase(torch, card):
    """6c: ``gpt2_small`` with its default dropouts (0.1 / 0.1) trains:
    O2 in bf16 (``decorate``) with AdamW's fp32 master weights, 5 steps
    of a user loop at batch 4 x 1024, then 5 through
    ``ShardedTrainer(recompute=True)``. Attention dropout keeps the plain
    attention, so K1 and K3 launch 0 times."""
    from paddle_tpu_torch.amp import auto_cast, decorate
    from paddle_tpu_torch.distributed import ShardedTrainer
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small
    from paddle_tpu_torch.nn.layers import LayerNorm
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt2_small()
    check(cfg.hidden_dropout == cfg.attention_dropout == 0.1,
          f"6c: gpt2_small's dropouts are {cfg.hidden_dropout}, "
          f"{cfg.attention_dropout}")
    batch, seq, steps = 4, 1024, 5
    L = cfg.num_layers
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()
    for how in ("loop", "ShardedTrainer(recompute=True)"):
        torch.manual_seed(0)
        model = GPTForCausalLM(cfg, device="cuda", seed=0)
        model.train()
        opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                    multi_precision=True)
        model, opt = decorate(model, opt, level="O2", dtype="bfloat16")
        trainer = ShardedTrainer(model, opt, None, recompute=True, amp=True,
                                 amp_dtype="bfloat16") \
            if how != "loop" else None
        for m in (fa, k2):
            m.reset_launches()
        losses = []
        for _ in range(steps):
            if trainer is not None:
                losses.append(trainer.train_step(ids, ids))
                continue
            with auto_cast(level="O2", dtype="bfloat16"):
                loss = model(ids, ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.detach())
        torch.cuda.synchronize()
        vals = [float(x) for x in losses]
        launches = {"K1": fa.launches["fwd"],
                    "K3": sum(fa.launches[n] for n in
                              ("bwd_fused", "bwd_dkv", "bwd_dq")),
                    "K2": k2.launches}
        # K2 twice a block and once for ln_f a forward; the trainer's
        # recompute replays the whole forward
        want = {"K1": 0, "K3": 0,
                "K2": (2 * L + 1) * steps * (2 if trainer else 1)}
        print(f"6c {how}: losses {vals}, launches {launches}", flush=True)
        check(all(np.isfinite(vals)), f"6c {how}: non-finite loss")
        check(vals[-1] < vals[0], f"6c {how}: loss did not fall: "
              f"{vals[0]} -> {vals[-1]}")
        check(launches == want, f"6c {how}: launch counts {launches} != "
              f"{want}")
        norms = {id(p) for m in model.modules() if isinstance(m, LayerNorm)
                 for p in m.parameters()}
        for p in model.parameters():
            norm = id(p) in norms
            check(p.dtype == (torch.float32 if norm else torch.bfloat16),
                  f"6c: a {'LayerNorm' if norm else 'non-norm'} parameter "
                  f"is {p.dtype} after decorate(O2)")
            st = opt._accumulators[id(p)]
            check(norm or (st["@master"].dtype == torch.float32
                           and st["moment1"].dtype == torch.float32),
                  "6c: a bf16 parameter has no fp32 master weight")
        del model, opt, trainer
    print(f"6c on {card}: gpt2_small with dropouts 0.1/0.1 trains in O2 "
          "bf16 with fp32 masters, by a loop and by ShardedTrainer("
          "recompute=True)", flush=True)


# 6d: a merged window of k micro-batches against one step on the whole
# batch, SGD in fp32 (no TF32) from the same weights. Both sides compute
# the same gradient but for summation order: the merge sums k per-micro-
# batch means, the full step one mean over the batch, and K3a's dQ
# atomics add in a run-dependent order. Each parameter is p - lr * g,
# rounded once to fp32 on each side, so the gate is element by element
# |merged - full| <= atol + rtol |full| with rtol 2**-22 (that one
# rounding on each side) and atol for lr times the gradients'
# difference. Over 4 runs on an H100 (two batches) the sound worst past
# rtol is 6.2e-9 to 8.2e-9 (max |merged - full| 5.96e-8, one fp32 ulp of
# the largest parameters; ~14M of the 124M elements differ at all;
# PERF.md, PR 15): atol sits 3.7x above it.
MERGE_TOL = {"atol": 3e-8, "rtol": 2.0 ** -22}
# 6d: losses of a trainer resumed from a checkpoint against the trainer
# that saved it, 3 steps each from bitwise-equal state (bf16 AMP,
# AdamW): the first is the same forward on the same weights (equal on
# the card); the next two follow updates whose gradients differ by
# K3a's dQ atomics' order. On an H100 they differ by up to 1.29e-5
# relatively (PERF.md, PR 15); the limit sits 7.8x above.
RESUME_RTOL = 1e-4


def _counts(fa, k2):
    return {"K1": fa.launches["fwd"], "K3a": fa.launches["bwd_fused"],
            "K3b": fa.launches["bwd_dkv"] + fa.launches["bwd_dq"],
            "K2": k2.launches}


def _merge_exactness(torch, cfg, ids, fa, k2):
    """6d.1a: 4 merged micro-batches of 4 x 1024 against one step on the
    16 x 1024 batch (SGD, fp32); exact launch counts a micro-step."""
    from paddle_tpu_torch.distributed import DistributedStrategy
    from paddle_tpu_torch.distributed import ShardedTrainer
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.optimizer import SGD

    L, k, lr = cfg.num_layers, 4, 0.1
    rows = ids.shape[0] // k

    def trainer(strategy):
        model = GPTForCausalLM(cfg, device="cuda", seed=0)
        model.train()
        return ShardedTrainer(model, SGD(lr, parameters=model.parameters()),
                              None, strategy=strategy)

    merged = trainer(DistributedStrategy(
        gradient_merge=True, gradient_merge_configs={"k_steps": k,
                                                     "avg": True}))
    start = [p.detach().clone() for p in merged.model.parameters()]
    want = {"K1": L, "K3a": L, "K3b": 0, "K2": 2 * L + 1}
    for i in range(k):
        torch.cuda.synchronize()
        for m in (fa, k2):
            m.reset_launches()
        part = ids[i * rows:(i + 1) * rows]
        merged.train_step(part, part)
        torch.cuda.synchronize()
        got = _counts(fa, k2)
        check(got == want, f"6d: micro-step {i} launches {got} != {want}")
    full = trainer(None)
    full.train_step(ids, ids)
    torch.cuda.synchronize()
    worst = {"abs": 0.0, "resid": 0.0, "differ": 0, "update": 0.0}
    for p0, pm, pf in zip(start, merged.model.parameters(),
                          full.model.parameters()):
        d = (pm.detach() - pf.detach()).abs()
        resid = d - MERGE_TOL["rtol"] * pf.detach().abs()
        worst["abs"] = max(worst["abs"], float(d.max()))
        worst["resid"] = max(worst["resid"], float(resid.max()))
        worst["differ"] += int((d > 0).sum())
        worst["update"] = max(worst["update"],
                              float((pf.detach() - p0).abs().max()))
    print(f"6d merge: 4 x {rows} x {ids.shape[1]} merged against 16 x "
          f"{ids.shape[1]} (SGD lr {lr}, fp32): max |merged - full| "
          f"{worst['abs']:.3e} ({worst['differ']} elements differ; the "
          f"largest update {worst['update']:.3e}), worst past rtol "
          f"2**-22 |full| {worst['resid']:.3e} (atol {MERGE_TOL['atol']})",
          flush=True)
    check(worst["resid"] <= MERGE_TOL["atol"], "6d: the merged window "
          f"differs from the full batch by {worst['resid']:.3e} past rtol "
          f"(atol {MERGE_TOL['atol']})")
    check(worst["update"] > 10 * MERGE_TOL["atol"],
          "6d: the full-batch step moved no parameter")


def _merge_perf(torch, card, cfg, ids, fa, k2, base):
    """6d.1b: 2 + 5 merged windows (4 x 4 x 1024) under AMP bf16 AdamW;
    tokens/s and step p50 (a window) beside phase 6's."""
    from paddle_tpu_torch.distributed import DistributedStrategy
    from paddle_tpu_torch.distributed import ShardedTrainer
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    L, k, warm, windows = cfg.num_layers, 4, 2, 5
    rows = ids.shape[0] // k
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    trainer = ShardedTrainer(
        model, AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01),
        None, amp=True, strategy=DistributedStrategy(
            gradient_merge=True, gradient_merge_configs={"k_steps": k}))

    def window():
        return [trainer.train_step(ids[i * rows:(i + 1) * rows],
                                   ids[i * rows:(i + 1) * rows])
                for i in range(k)]

    losses = [window() for _ in range(warm)]
    torch.cuda.synchronize()
    for m in (fa, k2):
        m.reset_launches()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(windows)]
    for start, end in ev:
        start.record()
        losses.append(window())
        end.record()
    torch.cuda.synchronize()
    got = _counts(fa, k2)
    want = {"K1": k * L * windows, "K3a": k * L * windows, "K3b": 0,
            "K2": k * (2 * L + 1) * windows}
    check(got == want, f"6d: merged AMP launches {got} != {want}")
    means = [float(np.mean([float(x) for x in w])) for w in losses]
    check(all(np.isfinite(means)), "6d: non-finite merged AMP loss")
    check(means[-1] < means[0], f"6d: merged loss did not fall: {means}")
    win_ms = [s.elapsed_time(e) for s, e in ev]
    total_ms = ev[0][0].elapsed_time(ev[-1][1])
    tokens_per_s = ids.numel() * windows / (total_ms / 1e3)
    print(f"6d merged windows on {card}: window means {means}; "
          f"{tokens_per_s:.1f} tokens/s (phase 6 {base['tokens_per_s']:.1f})"
          f", window p50 {float(np.median(win_ms)):.2f} ms (phase 6 step "
          f"{base['step_p50_ms']:.2f}), launches over {windows} windows "
          f"{got}", flush=True)
    _profile_step(torch, window, float(np.median(win_ms)))


def _flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _tfw(rec, what):
    from paddle_tpu_torch.distributed import TransientFailureWarning

    check(any(issubclass(w.category, TransientFailureWarning) for w in rec),
          f"6d: {what} raised no TransientFailureWarning")


def _anomaly_and_fallback(torch, card, cfg, ids, root):
    """6d.2: the anomaly policy through a float ``scale`` leaf of the
    batch (``loss_fn = loss * scale``, which ``nan_batch`` poisons), then
    a corrupt newest version that ``CheckpointManager.restore`` falls
    back from. Returns the checkpoint timings."""
    import warnings

    from paddle_tpu_torch.distributed import CheckpointManager, ShardedTrainer
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing import fault_injection as fi

    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01)
    trainer = ShardedTrainer(model, opt, lambda loss, s: loss * s, amp=True)
    scale = torch.ones((), device="cuda")

    def step():
        return trainer.train_step(ids, ids, scale)

    def planted(n):
        with warnings.catch_warnings(record=True) as rec, \
                fi.inject("trainer:batch", fi.nan_batch(), times=n) as inj:
            warnings.simplefilter("always")
            out = [step() for _ in range(n)]
        check(inj.fired == n, f"6d: {inj.fired} of {n} planted batches")
        return out, rec

    trainer.enable_anomaly_policy(policy="skip_step")
    for _ in range(2):
        step()
    snap, count = _snapshot(torch, model, opt), trainer.step_count
    (loss,), rec = planted(1)
    torch.cuda.synchronize()
    check(not np.isfinite(float(loss)), "6d: the planted loss is finite")
    check(trainer.step_count == count + 1 and
          trainer.anomaly_stats["skipped"] == 1,
          f"6d skip_step: step {trainer.step_count}, stats "
          f"{trainer.anomaly_stats}")
    _tfw(rec, "skip_step")
    check(_unchanged(torch, model, opt, snap), "6d skip_step: the planted "
          "step moved a parameter or an AdamW slot")
    check(np.isfinite(float(step())), "6d: no finite loss after the skip")

    trainer.enable_anomaly_policy(policy="raise")
    try:
        planted(1)
        fail("6d raise: the planted step did not raise")
    except FloatingPointError as e:
        print(f"6d raise: {e}", flush=True)

    mgr = CheckpointManager(os.path.join(root, "managed"), async_save=True)
    trainer.enable_anomaly_policy(policy="rollback", rollback_after=2,
                                  checkpoint_manager=mgr)
    snap, saved_step = _snapshot(torch, model, opt), trainer.step_count
    mgr.save()                   # committing while the bad steps land
    _, rec = planted(2)
    torch.cuda.synchronize()
    check(trainer.anomaly_stats["rollbacks"] == 1 and
          trainer.step_count == saved_step,
          f"6d rollback: step {trainer.step_count} (saved {saved_step}), "
          f"stats {trainer.anomaly_stats}")
    _tfw(rec, "rollback")
    check(_unchanged(torch, model, opt, snap), "6d rollback: the restored "
          "state is not the saved one bitwise")
    check(np.isfinite(float(step())), "6d: no finite loss after rollback")
    print(f"6d anomaly policy on {card}: skip_step, raise and rollback "
          f"(to step {saved_step}) as planted; stats "
          f"{trainer.anomaly_stats}", flush=True)

    # a newer version, saved asynchronously and timed, then corrupted
    t0 = time.perf_counter()
    mgr.save()
    stall = time.perf_counter() - t0
    mgr.wait()
    commit = time.perf_counter() - t0 - stall
    newest = os.path.join(mgr.path, f"v{trainer.step_count:012d}")
    nbytes = _dir_bytes(newest)
    _flip_byte(os.path.join(newest, "shard-0.npz"))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        back = mgr.restore()
    _tfw(rec, "the corrupt version")
    check(back == saved_step and trainer.step_count == saved_step,
          f"6d: restore fell back to step {back}, expected {saved_step}")
    check(_unchanged(torch, model, opt, snap), "6d: the fallback restore "
          "is not the older version bitwise")
    mgr.close()
    del snap
    return {"bytes": nbytes, "stall": stall, "commit": commit}


def _checkpoint_resume(torch, card, cfg, ids, root, timing):
    """6d.3: ``save_checkpoint`` from step 2; a trainer from another seed
    loads it bitwise (parameters, AdamW slots, step, scheduler), then 3
    steps of each agree."""
    from paddle_tpu_torch.distributed import ShardedTrainer, checkpoint
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, lr

    def make(seed):
        model = GPTForCausalLM(cfg, device="cuda", seed=seed)
        model.train()
        sched = lr.StepDecay(1e-4, step_size=2)
        opt = AdamW(sched, parameters=model.parameters(), weight_decay=0.01)
        return ShardedTrainer(model, opt, None, amp=True), sched

    def steps(t, sched, n):
        out = []
        for _ in range(n):
            out.append(t.train_step(ids, ids))
            sched.step()
        return [float(x) for x in out]

    saver, s_sched = make(0)
    steps(saver, s_sched, 2)
    path = os.path.join(root, "trainer")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    saver.save_checkpoint(path)
    blocking = time.perf_counter() - t0
    loader, l_sched = make(1)
    t0 = time.perf_counter()
    checkpoint.verify_checkpoint(path)
    verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    loader.load_checkpoint(path, verify=False)
    torch.cuda.synchronize()
    restore = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(
        saver.model.parameters(), loader.model.parameters())) and all(
        torch.equal(v, loader.optimizer._accumulators[id(q)][s])
        for p, q in zip(saver.model.parameters(), loader.model.parameters())
        for s, v in saver.optimizer._accumulators[id(p)].items())
    check(same, "6d: the loaded parameters or AdamW state differ from the "
          "saved ones")
    check(loader.step_count == saver.step_count == 2 and
          l_sched.state_dict() == s_sched.state_dict(),
          f"6d: loaded step {loader.step_count}, scheduler "
          f"{l_sched.state_dict()} against {s_sched.state_dict()}")
    a, b = steps(saver, s_sched, 3), steps(loader, l_sched, 3)
    rel = max(abs(x - y) / abs(x) for x, y in zip(a, b))
    print(f"6d resume: saver {a}, loader {b}, largest relative difference "
          f"{rel:.3e} (limit {RESUME_RTOL})", flush=True)
    check(all(np.isfinite(a + b)) and rel <= RESUME_RTOL,
          f"6d: resumed losses {b} against {a}")
    print(f"6d checkpoints on {card}: {timing['bytes']} bytes a version; "
          f"async save() stall {timing['stall']:.3f} s (the host snapshot) "
          f"against {timing['commit']:.3f} s of background commit; a "
          f"blocking save {blocking:.3f} s, the sha256 verify {verify:.3f} "
          f"s, a restore {restore:.3f} s", flush=True)


def training_resilience_phase(torch, card, base):
    """6d: fault-tolerant training of ``gpt2_small`` at full width and
    depth: gradient merge (exact against the full batch, then timed
    under AMP), the anomaly policy's three actions, checkpoints and a
    fallback past a corrupt version. Checkpoints go to a fresh temporary
    directory, deleted at the end."""
    import shutil
    import tempfile

    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    cfg = gpt2_small()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (16, 1024))).cuda()
    _merge_exactness(torch, cfg, ids, fa, k2)
    torch.cuda.empty_cache()
    _merge_perf(torch, card, cfg, ids, fa, k2, base)
    torch.cuda.empty_cache()
    # three versions on disk at once: params and two AdamW moments, fp32
    version = 3 * 4 * cfg.num_params()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        check(free > 3 * version + (2 << 30), f"6d: {free} bytes free under "
              f"{root}, the checkpoints need {3 * version} and 2 GiB spare")
        timing = _anomaly_and_fallback(torch, card, cfg, ids[:4], root)
        torch.cuda.empty_cache()
        _checkpoint_resume(torch, card, cfg, ids[:4], root, timing)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 7
# BERT-base pretraining (7a-7c), ERNIE-1.0 fine-tuning (7d) and
# nn.Transformer (7e) at full width and depth: the non-causal flash
# route of K1 and K3a, and K2 at epsilon 1e-12, on a training path
BERT_BATCH = (32, 512)        # batch, sequence
ERNIE_BATCH = (32, 128)
TRANSFORMER_BATCH = (16, 256)
MLM_MASK_ID = 103             # [MASK] in the BERT vocabulary
# 7b: the flash route against the plain one on the same function. Each
# route lies within FLASH_TOL of exact attention at every call (the
# flash kernels by their gate; the plain one in bf16 rounds logits and P
# to bf16, which is why FLASH_TOL's bf16 reference is the plain version
# in fp32), so the two within twice that, in the forward and again in
# the backward of each of the L calls; independent across layers, these
# add in quadrature: the loss within 2 FLASH_TOL sqrt(L) relatively,
# every gradient within 2 FLASH_TOL sqrt(2L) in norm relative to the
# plain route's. As FLASH_TOL's scale has a floor (max(1, max |plain|)),
# so does a gradient's: the root mean square of the gradients' norms,
# which a gradient that is zero in exact arithmetic (the key
# projection's bias: softmax ignores a shift shared by every key) would
# otherwise lack
ROUTE_DTYPES = ("float32", "bfloat16")


def _phase7_counts(fa, k2):
    return {"K1": fa.launches["fwd"], "K3a": fa.launches["bwd_fused"],
            "K3b-dkv": fa.launches["bwd_dkv"],
            "K3b-dq": fa.launches["bwd_dq"], "K2": k2.launches}


def _mlm_batch(torch, vocab, batch, seq, seed, pad=False):
    """Synthetic pretraining inputs: token ids, two segments, 15% of the
    (unpadded) positions masked (label the original id, -100 elsewhere)
    and an NSP label, packed as labels (batch, seq + 1); with ``pad``,
    10-20% of each row padded behind an ``attention_mask``."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1000, vocab, (batch, seq))
    split = rs.randint(seq // 4, 3 * seq // 4, (batch, 1))
    tt = (np.arange(seq)[None, :] >= split).astype(np.int64)
    keep = np.ones((batch, seq), bool)
    if pad:
        lengths = seq - rs.randint(int(0.1 * seq), int(0.2 * seq) + 1,
                                   (batch, 1))
        keep = np.arange(seq)[None, :] < lengths
    masked = (rs.rand(batch, seq) < 0.15) & keep
    mlm = np.where(masked, ids, -100)
    ids = np.where(masked, MLM_MASK_ID, np.where(keep, ids, 0))
    labels = np.concatenate([mlm, rs.randint(0, 2, (batch, 1))], axis=1)
    dev = [torch.from_numpy(a).cuda() for a in (ids, tt, labels)]
    mask = torch.from_numpy(keep.astype(np.int64)).cuda() if pad else None
    return dev[0], dev[1], mask, dev[2]


def _mlm_nsp_loss(out, label):
    from paddle_tpu_torch.nn import functional as F

    mlm_logits, nsp_logits = out
    return (F.cross_entropy(mlm_logits, label[:, :-1], ignore_index=-100)
            + F.cross_entropy(nsp_logits, label[:, -1]))


def _positional(torch, model, fn):
    """``model`` behind a forward that takes tensors only, as the
    trainer calls ``model(*inputs)``: ``fn(model, *inputs)``."""
    class Positional(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = model

        def forward(self, *xs):
            return fn(self.m, *xs)

    return Positional()


def _timed_steps(torch, trainer, batch, warm, steps, counters):
    """``warm`` steps, then ``steps`` timed on CUDA events with the
    launch counters set to 0 just before; returns (losses, step ms, total
    ms, launches of the timed steps)."""
    fa, k2 = counters
    losses = [trainer.train_step(*batch) for _ in range(warm)]
    torch.cuda.synchronize()
    for m in (fa, k2):
        m.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    for start, end in ev:
        start.record()
        losses.append(trainer.train_step(*batch))
        end.record()
    torch.cuda.synchronize()
    launches = _phase7_counts(fa, k2)
    return ([float(x) for x in losses], [s.elapsed_time(e) for s, e in ev],
            ev[0][0].elapsed_time(ev[-1][1]), launches)


def _train_perf(torch, card, what, n_params, tokens, step_ms, total_ms,
                launches):
    tokens_per_s = tokens * len(step_ms) / (total_ms / 1e3)
    perf = {"tokens_per_s": tokens_per_s,
            "step_p50_ms": float(np.median(step_ms)),
            "mfu": tokens_per_s * 6 * n_params / PEAK_FLOPS["bfloat16"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"{what} on {card}: {tokens_per_s:.1f} tokens/s, step p50 "
          f"{perf['step_p50_ms']:.2f} ms (min {min(step_ms):.2f}, max "
          f"{max(step_ms):.2f}), MFU {perf['mfu']:.4f} (6 x {n_params} "
          f"params / 989 TFLOP/s), peak memory {perf['peak_gib']:.2f} GiB, "
          f"launches over {len(step_ms)} steps {launches}", flush=True)
    return perf


def _check_counts(what, got, want):
    check(got == want, f"{what}: launch counts {got} != {want}")


def bert_phase(torch, card):
    """7a, 7b, 7c: returns the launch counts of 7a's timed steps and 7c's
    steps, and 7a's model."""
    from paddle_tpu_torch.distributed import ShardedTrainer
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.perf_counter()
    cfg = BertConfig(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    L = cfg.num_hidden_layers
    model = BertForPretraining(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    b, s = BERT_BATCH
    batch = _mlm_batch(torch, cfg.vocab_size, b, s, seed=70)
    ids, tt, _, labels = batch
    trainer = ShardedTrainer(model, AdamW(learning_rate=1e-4,
                                          parameters=model.parameters(),
                                          weight_decay=0.01),
                             _mlm_nsp_loss, amp=True)
    losses, step_ms, total_ms, launches = _timed_steps(
        torch, trainer, (ids, tt, labels), 2, 10, (fa, k2))
    print(f"7a BERT-base losses: {losses}", flush=True)
    check(all(np.isfinite(losses)), "7a: non-finite loss")
    check(losses[-1] < losses[0], f"7a: loss did not fall: {losses[0]} -> "
          f"{losses[-1]}")
    _check_counts("7a", launches, {"K1": 10 * L, "K3a": 10 * L,
                                   "K3b-dkv": 0, "K3b-dq": 0,
                                   "K2": 10 * (2 * L + 2)})
    perf = _train_perf(torch, card, "7a BERT-base pretraining", n_params,
                       b * s, step_ms, total_ms, launches)
    _profile_step(torch, lambda: trainer.train_step(ids, tt, labels),
                  perf["step_p50_ms"])
    print(f"7a: {time.perf_counter() - t0:.1f} s wall", flush=True)
    route_phase(torch, model, batch, L, (fa, k2))
    defaults = bert_defaults_phase(torch, card, (fa, k2))
    return launches, defaults, perf


def route_phase(torch, model, batch, L, counters):
    """7b: one forward and backward of 7a's model with no mask (K1a,
    K3a) and with an all-ones padding mask (the plain attention), in fp32
    and under bf16 AMP: the loss and every gradient held to each other."""
    from paddle_tpu_torch.amp import auto_cast

    fa, k2 = counters
    ids, tt, _, labels = batch
    ones = torch.ones_like(ids)
    params = [p for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]
    for dn in ROUTE_DTYPES:
        got = {}
        for route, mask in (("flash", None), ("plain", ones)):
            fa.reset_launches()
            with auto_cast(enable=dn != "float32", dtype="bfloat16"):
                loss = _mlm_nsp_loss(model(ids, tt, mask), labels).float()
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            got[route] = (float(loss), grads, dict(fa.launches))
        check(got["flash"][2]["fwd"] == L and got["flash"][2]["bwd_fused"]
              == L and got["plain"][2]["fwd"] == 0
              and got["plain"][2]["bwd_fused"] == 0,
              f"7b {dn}: routes launched {got['flash'][2]} (flash) and "
              f"{got['plain'][2]} (masked)")
        loss_f, loss_p = got["flash"][0], got["plain"][0]
        loss_rel = abs(loss_f - loss_p) / abs(loss_p)
        loss_lim = 2 * FLASH_TOL[dn] * L ** 0.5
        grad_lim = 2 * FLASH_TOL[dn] * (2 * L) ** 0.5
        norms = torch.stack([gp.float().norm() for gp in got["plain"][1]])
        floor = norms.norm() / len(names) ** 0.5
        worst, worst_name = 0.0, None
        for n, gf, gp, gn in zip(names, got["flash"][1], got["plain"][1],
                                 norms):
            check(bool(torch.isfinite(gf).all()), f"7b {dn}: non-finite {n}")
            rel = float((gf.float() - gp.float()).norm()
                        / torch.maximum(gn, floor))
            if rel > worst:
                worst, worst_name = rel, n
        print(f"7b {dn}: loss flash {loss_f!r}, plain {loss_p!r}, relative "
              f"{loss_rel:.3g} (limit {loss_lim:.3g}); worst gradient "
              f"{worst_name} {worst:.3g} in norm (limit {grad_lim:.3g}) "
              f"over {len(names)} parameters", flush=True)
        check(loss_rel <= loss_lim, f"7b {dn}: loss {loss_f} vs {loss_p}")
        check(worst <= grad_lim, f"7b {dn}: gradient {worst_name} differs "
              f"by {worst} > {grad_lim}")
        del got


def bert_defaults_phase(torch, card, counters):
    """7c: BERT-base at its defaults (0.1 dropouts) on padded batches:
    attention takes the plain route (K1 = K3a = 0), K2 exact."""
    from paddle_tpu_torch.distributed import ShardedTrainer
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    fa, k2 = counters
    cfg = BertConfig()
    L = cfg.num_hidden_layers
    model = BertForPretraining(cfg, device="cuda", seed=1)
    trainer = ShardedTrainer(model, AdamW(learning_rate=1e-4,
                                          parameters=model.parameters()),
                             _mlm_nsp_loss, amp=True)
    b, s = BERT_BATCH
    batches = [_mlm_batch(torch, cfg.vocab_size, b, s, seed=80 + i, pad=True)
               for i in range(3)]
    pad = float(np.mean([1.0 - float(m.float().mean())
                         for _, _, m, _ in batches]))
    fa.reset_launches()
    k2.reset_launches()
    losses = [float(trainer.train_step(*bt)) for bt in batches]
    torch.cuda.synchronize()
    launches = _phase7_counts(fa, k2)
    print(f"7c BERT-base at its defaults, {pad:.3f} of the positions "
          f"padded: losses {losses}, launches {launches}", flush=True)
    check(all(np.isfinite(losses)), "7c: non-finite loss")
    _check_counts("7c", launches, {"K1": 0, "K3a": 0, "K3b-dkv": 0,
                                   "K3b-dq": 0, "K2": 3 * (2 * L + 2)})
    return launches


def ernie_phase(torch, card):
    """7d: ERNIE-1.0 fine-tuning (task-type ids, dropout 0), then
    ``eval_step`` and ``predict_step``; returns the launch counts of the
    10 timed steps and of the eval and predict forwards, and the perf."""
    from paddle_tpu_torch.distributed import ShardedTrainer
    from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                         ernie_1_0)
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.perf_counter()
    cfg = ernie_1_0()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    L = cfg.num_hidden_layers
    clf = ErnieForSequenceClassification(cfg, device="cuda", seed=2)
    n_params = sum(p.numel() for p in clf.parameters())
    model = _positional(torch, clf, lambda m, ids, tt, task: m(
        ids, tt, None, task))
    b, s = ERNIE_BATCH
    rs = np.random.RandomState(90)
    ids, tt, task = (torch.from_numpy(a).cuda() for a in (
        rs.randint(1, cfg.vocab_size, (b, s)), rs.randint(0, 2, (b, s)),
        rs.randint(0, cfg.task_type_vocab_size, (b, s))))
    labels = torch.from_numpy(rs.randint(0, cfg.num_labels, b)).cuda()
    trainer = ShardedTrainer(model, AdamW(learning_rate=5e-5,
                                          parameters=model.parameters()),
                             lambda out, y: F.cross_entropy(out, y),
                             amp=True)
    losses, step_ms, total_ms, launches = _timed_steps(
        torch, trainer, (ids, tt, task, labels), 2, 10, (fa, k2))
    print(f"7d ERNIE-1.0 losses: {losses}", flush=True)
    check(all(np.isfinite(losses)), "7d: non-finite loss")
    check(losses[-1] < losses[0], f"7d: loss did not fall: {losses[0]} -> "
          f"{losses[-1]}")
    _check_counts("7d", launches, {"K1": 10 * L, "K3a": 10 * L,
                                   "K3b-dkv": 0, "K3b-dq": 0,
                                   "K2": 10 * (2 * L + 1)})
    perf = _train_perf(torch, card, "7d ERNIE-1.0 fine-tuning", n_params,
                       b * s, step_ms, total_ms, launches)
    fa.reset_launches()
    k2.reset_launches()
    ev = float(trainer.eval_step(ids, tt, task, labels))
    logits = trainer.predict_step(ids, tt, task)
    torch.cuda.synchronize()
    inference = _phase7_counts(fa, k2)
    check(np.isfinite(ev) and tuple(logits.shape) == (b, cfg.num_labels)
          and bool(torch.isfinite(logits.float()).all()),
          f"7d: eval loss {ev}, predict {tuple(logits.shape)}")
    _check_counts("7d eval + predict", inference,
                  {"K1": 2 * L, "K3a": 0, "K3b-dkv": 0, "K3b-dq": 0,
                   "K2": 2 * (2 * L + 1)})
    print(f"7d: eval loss {ev!r}, predict logits {tuple(logits.shape)}, "
          f"launches {inference}; {time.perf_counter() - t0:.1f} s wall",
          flush=True)
    return launches, inference, perf


def transformer_phase(torch, card):
    """7e: ``nn.Transformer()`` at its defaults, dropout 0, one training
    step with the causal ``tgt_mask``: encoder self-attention and decoder
    cross-attention on K1/K3a, the masked decoder self-attention plain."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import ShardedTrainer
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.optimizer import AdamW

    net = nn.Transformer(dropout=0.0, device="cuda")
    enc, dec = len(net.encoder.layers), len(net.decoder.layers)
    model = _positional(torch, net, lambda m, src, tgt, tgt_mask: m(
        src, tgt, None, tgt_mask))
    b, s = TRANSFORMER_BATCH
    g = torch.Generator(device="cuda").manual_seed(100)
    src, tgt, target = (torch.randn(b, s, net.d_model, device="cuda",
                                    generator=g) for _ in range(3))
    tgt_mask = nn.Transformer.generate_square_subsequent_mask(s,
                                                              device="cuda")
    trainer = ShardedTrainer(model, AdamW(learning_rate=1e-4,
                                          parameters=model.parameters()),
                             lambda out, y: ((out.float() - y) ** 2).mean(),
                             amp=True)
    fa.reset_launches()
    k2.reset_launches()
    loss = float(trainer.train_step(src, tgt, tgt_mask, target))
    torch.cuda.synchronize()
    launches = _phase7_counts(fa, k2)
    print(f"7e nn.Transformer (d_model {net.d_model}, {net.nhead} heads, "
          f"{enc} + {dec} layers), batch {b} x {s}: loss {loss!r}, launches "
          f"{launches}", flush=True)
    check(np.isfinite(loss), "7e: non-finite loss")
    _check_counts("7e", launches, {"K1": enc + dec, "K3a": enc + dec,
                                   "K3b-dkv": 0, "K3b-dq": 0,
                                   "K2": 2 * enc + 3 * dec})
    return launches


def encoder_phase(torch, card):
    """Phase 7; returns the K1, K3a and K2 launches of its main paths
    (7a's timed steps, 7c, 7d's steps and forwards, 7e)."""
    bert, defaults, bert_perf = bert_phase(torch, card)
    ernie, ernie_inf, ernie_perf = ernie_phase(torch, card)
    tf = transformer_phase(torch, card)
    return {k: bert[k] + defaults[k] + ernie[k] + ernie_inf[k] + tf[k]
            for k in ("K1", "K3a", "K2")}


# -- phase 6e: ZeRO offload ----------------------------------------------------

class _GradTap:
    """An optimizer wrapper for 6e's bitwise comparison: ``record`` keeps
    a copy of each gradient the update gets; ``replay`` (another tap)
    overwrites its own gradients with those first. K3a's dQ atomics make
    the backward's last bits differ from run to run (csrc/flash_bwd.cu),
    so two runs of the same steps are bitwise equal only when their
    updates see the same gradients; the forwards, the updates and the
    offload's copies are then all that remain to compare."""

    def __init__(self, inner, source=None):
        self._inner = inner
        self._source = source
        self.grads = None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def inner_opt(self):
        return self._inner

    def step(self):
        params = [p for p in self._inner._parameter_list
                  if p.grad is not None]
        if self._source is None:
            self.grads = [p.grad.detach().clone() for p in params]
        else:
            for p, g in zip(params, self._source.grads):
                p.grad.copy_(g)
        self._inner.step()

    def clear_grad(self):
        self._inner.clear_grad()


def _slots_pinned(trainer) -> bool:
    """Every non-scalar slot of ``trainer``'s optimizer in pinned host
    memory, every 0-dim slot on the card."""
    for st in trainer.optimizer._named_state(trainer._names).values():
        for v in st.values():
            if v.dim() == 0:
                if v.device.type != "cuda":
                    return False
            elif v.device.type != "cpu" or not v.is_pinned():
                return False
    return True


def _phase6_trainer(torch, cfg, offload, tap=None):
    from paddle_tpu_torch.distributed import DistributedStrategy, ShardedTrainer
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                weight_decay=0.01)
    if tap is not None:
        opt = tap(opt)
    st = DistributedStrategy(sharding=offload,
                             sharding_configs={"offload": offload})
    return ShardedTrainer(model, opt, None, amp=True, strategy=st)


def offload_phase(torch, card, base):
    """Phase 6e: phase 6's configuration (``gpt2_small``, 16 x 1024, AMP
    bf16, AdamW) under ``sharding_configs={"offload": True}``. Bitwise: 12
    steps of an offloaded trainer in lockstep with 12 of one without, the
    same gradients fed to both updates (``_GradTap``): every loss, every
    parameter, every slot equal, the offloaded trainer's checkpoint read
    back equal to the state the plain trainer's save writes, and
    every non-scalar slot pinned host memory after each step. Then the
    offloaded trainer alone, its gradients its own again: 10 timed steps
    (CUDA events), the peak memory, one profiled step, and the slots'
    copy in and out timed on their own, beside phase 6's ``base``.
    Returns the launches of all 35 offloaded and plain steps."""
    import gc
    import tempfile

    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    cfg = gpt2_small()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    batch, seq, warm, steps = 16, 1024, 2, 10
    L = cfg.num_layers
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()
    fa.reset_launches()
    k2.reset_launches()

    plain = _phase6_trainer(torch, cfg, False, _GradTap)
    off = _phase6_trainer(torch, cfg, True,
                          lambda o: _GradTap(o, source=plain.optimizer))
    nbytes = sum(v.numel() * v.element_size()
                 for v in off._host_slots.values())
    check(_slots_pinned(off), "6e: a slot is not in pinned host memory")
    for i in range(warm + steps):
        lp = plain.train_step(ids, ids)
        lo = off.train_step(ids, ids)
        check(torch.equal(lp, lo), f"6e: step {i + 1} loss {float(lo)!r} "
              f"offloaded, {float(lp)!r} not")
        check(_slots_pinned(off), f"6e: after step {i + 1} a slot is not "
              "in pinned host memory")
    for n, p in plain.param_tensors.items():
        check(torch.equal(p, off.param_tensors[n]),
              f"6e: parameter {n} differs after 12 steps")
    a_st, b_st = plain._opt_states(), off._opt_states()
    for n in a_st:
        for slot, v in a_st[n].items():
            check(torch.equal(v.cpu(), b_st[n][slot].cpu()),
                  f"6e: slot {n}/{slot} differs after 12 steps")
    # the offloaded trainer's checkpoint, read back, against what the
    # plain trainer's save writes (its state as the save snapshots it;
    # 6d holds a save and its load to each other bitwise)
    a = {k: v.cpu() for k, v in plain._checkpoint_state().items()}
    with tempfile.TemporaryDirectory() as root:
        off.save_checkpoint(root)
        b, eb = ckpt.load_state(root, verify=False, device="cpu")
    check(a.keys() == b.keys() and eb["step"] == warm + steps
          and all(torch.equal(a[k], b[k]) for k in a),
          "6e: the offloaded trainer's checkpoint differs")
    print(f"6e: 12 lockstep steps on {card}: losses, {len(a_st)} "
          f"parameters, their slots and the checkpoint ({len(a)} arrays) "
          f"bitwise equal with and without offload; {len(off._host_slots)} "
          f"slots, {nbytes} bytes, in pinned host memory after every step",
          flush=True)
    # the offloaded trainer alone, warm, on its own gradients
    t = off
    t.optimizer = t.optimizer.inner_opt
    first = float(lo)
    del plain, off, a, b, a_st, b_st, lp, lo
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    for start, end in ev:
        start.record()
        losses.append(t.train_step(ids, ids))
        end.record()
    torch.cuda.synchronize()
    t._offload_wait()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [s.elapsed_time(e) for s, e in ev]
    total_ms = ev[0][0].elapsed_time(ev[-1][1])
    vals = [float(x) for x in losses]
    check(all(np.isfinite(vals)) and vals[-1] < first,
          f"6e: losses {vals} after {first}")
    tok_s = batch * seq * steps / (total_ms / 1e3)
    p50 = float(np.median(step_ms))
    # the copies alone: in on the compute stream (CUDA events), out on
    # the side stream (host clock to its event)
    t._stream_in()
    s0, s1 = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    t._stream_out()
    torch.cuda.synchronize()
    s0.record()
    t._stream_in()
    s1.record()
    torch.cuda.synchronize()
    in_ms = s0.elapsed_time(s1)
    h0 = time.perf_counter()
    t._stream_out()
    t._offload_wait()
    out_ms = (time.perf_counter() - h0) * 1e3
    check(_slots_pinned(t), "6e: a slot left pinned memory")
    print(f"6e offload on {card}: {tok_s:.1f} tokens/s, step p50 {p50:.2f} "
          f"ms (min {min(step_ms):.2f}, max {max(step_ms):.2f}), peak memory "
          f"{peak:.2f} GiB; phase 6: {base['tokens_per_s']:.1f} tokens/s, "
          f"p50 {base['step_p50_ms']:.2f} ms, peak {base['peak_gib']:.2f} "
          f"GiB ({resident:.2f} GiB of it the trainer's before the steps); "
          f"the "
          f"slots' {nbytes} bytes each way: in {in_ms:.2f} ms "
          f"({nbytes / in_ms / 1e6:.1f} GB/s, CUDA events), out "
          f"{out_ms:.2f} ms ({nbytes / out_ms / 1e6:.1f} GB/s, host clock); "
          f"losses {vals}", flush=True)
    _profile_step(torch, lambda: t.train_step(ids, ids), p50)
    t._offload_wait()
    launches = {"K1": fa.launches["fwd"], "K3a": fa.launches["bwd_fused"],
                "K2": k2.launches}
    n = 2 * (warm + steps) + steps + 1
    want = {"K1": L * n, "K3a": L * n, "K2": (2 * L + 1) * n}
    check(launches == want, f"6e: launches {launches} != {want} for {n} "
          "steps")
    del t
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- phase 6f: the other optimizers, fleet and ASP ------------------------------

# 6f's parity: the update of one step on the card (fp32, no AMP) against
# the same step on the CPU, both at gpt_tiny (4 heads of 16: the forward
# kernel at its run-time head dim, the backward's padded to 64) from the
# same weights, in global L2 norm: the two differ in summation order
# (cuBLAS and the flash kernels against the CPU's plain versions), ~1e-6
# relatively in the gradients, and no rule here amplifies that past 1e-4
OPT_TOL = 1e-3


def _optimizer_cases():
    """(label, factory(named parameters) -> optimizer, check(wrapper)) of
    6f: the five new optimizers (RMSProp centered and not), Lars through
    ``fleet.distributed_optimizer`` over a Momentum, LocalSGD (k 2) over
    AdamW, and AdamW decorated by ASP (after ``prune_model``)."""
    from paddle_tpu_torch.distributed import DistributedStrategy, fleet
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.optimizer import (Adadelta, Adagrad, Adamax, AdamW,
                                            Lamb, Lars, Momentum, RMSProp)

    lars = DistributedStrategy(lars=True, lars_configs={
        "lars_coeff": 0.001, "exclude_from_weight_decay": ["bias", "ln_"]})
    local = DistributedStrategy(localsgd=True,
                                localsgd_configs={"k_steps": 2})
    return [
        ("Adagrad", lambda ps: Adagrad(1e-3, parameters=ps), None),
        ("Adamax", lambda ps: Adamax(1e-4, parameters=ps), None),
        ("RMSProp", lambda ps: RMSProp(1e-4, parameters=ps), None),
        ("RMSProp centered", lambda ps: RMSProp(
            1e-4, centered=True, momentum=0.9, parameters=ps), None),
        ("Lamb", lambda ps: Lamb(1e-3, parameters=ps), None),
        ("Adadelta", lambda ps: Adadelta(1.0, parameters=ps), None),
        ("fleet Lars", lambda ps: fleet.distributed_optimizer(
            Momentum(0.1, parameters=ps), strategy=lars),
         lambda o: isinstance(o.inner_opt, Lars)),
        ("fleet LocalSGD", lambda ps: fleet.distributed_optimizer(
            AdamW(1e-4, parameters=ps), strategy=local),
         lambda o: o._sync_count == 1),
        ("ASP", lambda ps: asp.decorate(AdamW(1e-4, parameters=ps)), None),
    ]


def _one_step_update(torch, cfg, label, make, ids, device, prune):
    """The change one training step (fp32, no AMP) makes to every
    parameter of ``cfg`` built from seed 0 on ``device``."""
    from paddle_tpu_torch.distributed import ShardedTrainer
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.models import GPTForCausalLM

    model = GPTForCausalLM(cfg, device="cpu", seed=0).to(device)
    model.train()
    if prune:
        asp.prune_model(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    t = ShardedTrainer(model, make(model.named_parameters()), None)
    x = ids.to(device)
    t.train_step(x, x)
    return {n: (p.detach() - before[n]).cpu()
            for n, p in model.named_parameters()}


def optimizers_phase(torch, card):
    """Phase 6f: each of ``_optimizer_cases`` trains ``gpt2_small`` at 4 x
    1024 under AMP bf16 through ``ShardedTrainer`` for 3 steps from the
    same weights: finite losses, K1 = K3a = L and K2 = 2L + 1 a step,
    the wrapper's own check (Lars inside, one LocalSGD sync), every
    pruned weight 2:4 sparse after every step (ASP); then each one's
    first update at ``gpt_tiny`` (fp32, TF32 off) on the card against the
    CPU within OPT_TOL in global norm. Returns the
    phase's launches."""
    from paddle_tpu_torch.distributed import ShardedTrainer
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small, gpt_tiny
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    cfg = gpt2_small()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    L, steps = cfg.num_layers, 3
    ids = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (4, 1024))).cuda()
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    total = {"K1": 0, "K3a": 0, "K2": 0}
    for label, make, extra in _optimizer_cases():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        masks = {}
        t0 = time.perf_counter()
        if label == "ASP":
            asp.reset_excluded_layers()
            masks = asp.prune_model(model)
        prune_s = time.perf_counter() - t0
        opt = make(model.named_parameters())
        t = ShardedTrainer(model, opt, None, amp=True)
        torch.cuda.synchronize()
        fa.reset_launches()
        k2.reset_launches()
        params = dict(model.named_parameters())
        losses = []
        for _ in range(steps):
            losses.append(float(t.train_step(ids, ids)))
            if masks:
                check(all(asp.check_sparsity(params[n]) for n in masks),
                      "6f ASP: a pruned weight lost its 2:4 pattern")
        launches = {"K1": fa.launches["fwd"], "K3a": fa.launches["bwd_fused"],
                    "K2": k2.launches}
        for k in total:
            total[k] += launches[k]
        want = {"K1": L * steps, "K3a": L * steps, "K2": (2 * L + 1) * steps}
        check(all(np.isfinite(losses)) and launches == want
              and (extra is None or extra(opt)),
              f"6f {label}: losses {losses}, launches {launches} != {want}")
        print(f"6f {label}: losses {losses}, launches {launches}"
              + (f", {len(masks)} weights pruned 2:4 in {prune_s:.2f} s, "
                 "sparse after every step" if masks else ""), flush=True)
        del t, opt
    del model, init
    torch.cuda.empty_cache()

    tiny = gpt_tiny()
    tiny.hidden_dropout = tiny.attention_dropout = 0.0
    tids = torch.from_numpy(np.random.RandomState(7).randint(
        0, tiny.vocab_size, (2, 128)))
    worst = []
    for label, make, _ in _optimizer_cases():
        got = _one_step_update(torch, tiny, label, make, tids, "cuda",
                               label == "ASP")
        want = _one_step_update(torch, tiny, label, make, tids, "cpu",
                                label == "ASP")
        num = sum(float((got[n] - want[n]).double().pow(2).sum())
                  for n in want) ** 0.5
        den = sum(float(want[n].double().pow(2).sum()) for n in want) ** 0.5
        rel = num / den
        worst.append((label, rel))
        check(rel <= OPT_TOL, f"6f {label}: the card's first update differs "
              f"from the CPU's by {rel:.3g} in norm (limit {OPT_TOL})")
    print("6f first update, card vs CPU at gpt_tiny, 4 heads of 16 (fp32, "
          f"relative in global norm, limit {OPT_TOL}): "
          + ", ".join(f"{lb} {r:.3g}" for lb, r in worst), flush=True)
    return total


# -- phase 5o: the small head dims on the paged engine --------------------------

# 5o's trace: 8 greedy requests from RandomState(5), prompts of 8-60
# tokens and 24-60 new, within gpt_tiny's 128 positions
SMALL_HEADS_TRACE = (8, (8, 60), (24, 60))


def _small_trace(vocab):
    n, (p_lo, p_hi), (g_lo, g_hi) = SMALL_HEADS_TRACE
    rs = np.random.RandomState(5)
    out = []
    for _ in range(n):
        p = int(rs.randint(p_lo, p_hi + 1))
        g = min(int(rs.randint(g_lo, g_hi + 1)), 127 - p)
        out.append(dict(prompt=rs.randint(0, vocab, p).tolist(),
                        max_new_tokens=g, greedy=True))
    return out


def small_heads_phase(torch, card):
    """Phase 5o: the paged engine serves ``gpt_tiny`` (4 heads of 16) and
    ``gpt_tiny8`` (8 heads of 8) at full width, fp32, on fp32 pools and
    on int8 pools: K4 and K5 at their run-time head dims. Gates: exact
    launch counts; on fp32 pools every greedy token the teacher-forced
    argmax but at a near-tie; on int8 pools greedy agreement with it >=
    0.9 (the int8 arena's contract, test_paged_kv.py:502). Returns the
    launch counts of the four runs, summed."""
    from paddle_tpu_torch.inference import Request, ServingEngine
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny, gpt_tiny8
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    total = {"K2": 0, "K4": 0, "K5": 0, "K4-int8": 0, "K5-int8": 0}
    for name, make in (("gpt_tiny", gpt_tiny), ("gpt_tiny8", gpt_tiny8)):
        cfg = make()
        model = GPTForCausalLM(cfg, device="cuda", seed=0)
        model.eval()
        trace = _small_trace(cfg.vocab_size)
        d = cfg.hidden_size // cfg.num_heads
        for kv in (None, "int8"):
            what = f"5o {name} (head dim {d}){', int8 pools' if kv else ''}"
            eng = ServingEngine(model, max_batch_slots=4, max_len=128,
                                block_size=16, prefill_chunk=32, seed=0,
                                device="cuda", kv_dtype=kv)
            eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4,
                               greedy=True))
            eng.run()
            reqs = [eng.submit(Request(**kw)) for kw in trace]
            torch.cuda.synchronize()
            for m in (k2, k4, k5):
                m.reset_launches()
            agg = eng.run().aggregate()
            torch.cuda.synchronize()
            launches = {"K2": k2.launches, "K4": k4.launches,
                        "K5": k5.launches, "K4-int8": k4.launches_q,
                        "K5-int8": k5.launches_q}
            check(all(r.status == "done" for r in reqs),
                  f"{what}: a request did not finish")
            chunks = int(agg["prefill_chunks"])
            steps = int(agg["decode_steps"])
            _check_launches(what, launches, cfg.num_layers, chunks, steps,
                            int8=kv is not None)
            for k in total:
                total[k] += launches[k]
            if kv is None:
                _greedy_consistency(torch, model, reqs, what)
            else:
                agree, n = _agreement(torch, model, reqs)
                print(f"{what}: greedy agreement with the fp32 argmax "
                      f"{agree}/{n} = {agree / n:.4f} (limit 0.9)",
                      flush=True)
                check(agree / n >= 0.9, f"{what}: greedy agreement "
                      f"{agree / n} < 0.9")
            print(f"{what}: {len(reqs)} requests, {chunks} prefill chunks, "
                  f"{steps} decode steps, launches {launches}", flush=True)
        del model
    return total


# -- phase 6g: GPT-3 XL trained at full width -----------------------------------

GPT3_BATCH = (8, 2048, 2, 5)     # batch, sequence, warm-up, timed steps


def _head_ms(torch, model, ids):
    """Device ms of the fused fp32 head (``F.linear_cross_entropy``,
    forward and backward) alone at the step's shape, median of 3."""
    import paddle_tpu_torch.nn.functional as F

    h = torch.randn(ids.shape[0], ids.shape[1] - 1,
                    model.config.hidden_size, device="cuda",
                    requires_grad=True)
    w = model.gpt.wte.weight

    def head():
        loss = F.linear_cross_entropy(h, w, ids[:, 1:], reduction="mean",
                                      w_vocab_major=True)
        torch.autograd.grad(loss, (h, w))

    return _dev_ms(torch, head, reps=3)


def gpt3_training_phase(torch, card):
    """Phase 6g: ``GPTForCausalLM(gpt3_1p3b())`` at full width and depth
    (24 layers, hidden 2048, 16 heads of 128, vocab 50304), dropout 0,
    trained by ``ShardedTrainer`` with AdamW under AMP bf16 at 8 x 2048
    for 2 warm-up and 5 timed steps, no recompute: the first loss finite
    and within 0.5 of ln 50304, the loss falling on the fixed batch, K1 =
    K3a = 24 and K2 = 49 a timed step. Prints tokens/s, step p50, MFU,
    peak memory, one profiled step and the fp32 head's share of the
    step. Returns the timed steps' launches."""
    import gc
    import math

    from paddle_tpu_torch.distributed import ShardedTrainer
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt3_1p3b()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    batch, seq, warm, steps = GPT3_BATCH
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    trainer = ShardedTrainer(model, opt, None, amp=True)
    losses = [trainer.train_step(ids, ids) for _ in range(warm)]
    torch.cuda.synchronize()
    first = float(losses[0])
    check(np.isfinite(first) and abs(first - math.log(cfg.vocab_size))
          <= 0.5, f"6g: first loss {first} not within 0.5 of ln "
          f"{cfg.vocab_size} = {math.log(cfg.vocab_size):.4f}")
    for m in (fa, k2):
        m.reset_launches()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    for start, end in ev:
        start.record()
        losses.append(trainer.train_step(ids, ids))
        end.record()
    torch.cuda.synchronize()
    launches = {"K1": fa.launches["fwd"], "K3a": fa.launches["bwd_fused"],
                "K3b-dkv": fa.launches["bwd_dkv"],
                "K3b-dq": fa.launches["bwd_dq"], "K2": k2.launches}
    vals = [float(x) for x in losses]
    print(f"6g losses: {vals}", flush=True)
    check(all(np.isfinite(vals)), "6g: non-finite training loss")
    check(vals[-1] < vals[0], f"6g: loss did not fall: {vals[0]} -> "
          f"{vals[-1]}")
    L = cfg.num_layers
    want = {"K1": L * steps, "K3a": L * steps, "K3b-dkv": 0, "K3b-dq": 0,
            "K2": (2 * L + 1) * steps}
    check(launches == want, f"6g launch counts {launches} != {want} for "
          f"{steps} steps")
    step_ms = [s.elapsed_time(e) for s, e in ev]
    total_ms = ev[0][0].elapsed_time(ev[-1][1])
    tokens_per_s = batch * seq * steps / (total_ms / 1e3)
    n_params = cfg.num_params()
    mfu = tokens_per_s * 6 * n_params / PEAK_FLOPS["bfloat16"]
    p50 = float(np.median(step_ms))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"6g gpt3_1p3b training on {card}: {tokens_per_s:.1f} tokens/s, "
          f"step p50 {p50:.2f} ms (min {min(step_ms):.2f}, max "
          f"{max(step_ms):.2f}), MFU {mfu:.4f} (6 x {n_params} params / "
          f"989 TFLOP/s), peak memory {peak:.2f} GiB (no recompute), "
          f"launches over {steps} steps {launches}", flush=True)
    _profile_step(torch, lambda: trainer.train_step(ids, ids), p50)
    head = _head_ms(torch, model, ids)
    print(f"6g: the fp32 head (linear_cross_entropy forward and backward "
          f"at {batch} x {seq - 1} x {cfg.hidden_size} against "
          f"{cfg.vocab_size} rows) alone {head:.2f} ms = {head / p50:.3f} "
          f"of the step p50; the rest (blocks, optimizer) {p50 - head:.2f} "
          "ms", flush=True)
    del trainer, opt, model, losses
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- phase 5n: GPT-3 served in bf16 -------------------------------------------------

def _bf16_serving(torch, card, model, trace, what, pools, prepare=None,
                  after=None, min_agree=0.9):
    """``trace`` through ``_serve`` on ``model`` (bf16) over each of
    ``pools`` (None: bf16 pools, "int8"): exact launch counts and greedy
    agreement with the bf16 teacher-forced argmax >= ``min_agree`` (None:
    printed only). ``prepare`` goes to ``_serve``; ``after(label, agg,
    reqs)`` runs right after each counted run. Returns the launches of
    each run by pool."""
    out = {}
    L = model.config.num_layers
    for kv in pools:
        label = f"{what}{', int8 pools' if kv else ''}"
        _, reqs, agg, wall, launches = _serve(torch, model, trace,
                                              kv_dtype=kv, prepare=prepare)
        if after is not None:
            after(label, agg, reqs)
        chunks, steps = int(agg["prefill_chunks"]), int(agg["decode_steps"])
        print(f"{label}: {int(agg['completed'])} requests, {chunks} prefill "
              f"chunks, {steps} decode steps, launches {launches}",
              flush=True)
        _check_launches(label, launches, L, chunks, steps,
                        int8=kv is not None)
        agree, total = _agreement(torch, model, reqs)
        print(f"{label}: greedy agreement with the bf16 argmax {agree}/"
              f"{total} = {agree / total:.4f} (limit {min_agree})",
              flush=True)
        check(min_agree is None or agree / total >= min_agree,
              f"{label}: greedy agreement {agree / total} < {min_agree}")
        print(_perf_line(label, card, agg, wall), flush=True)
        out[kv] = launches
    return out


def gpt3_serving_phase(torch, card):
    """Phase 5n: (a) ``gpt3_1p3b`` in bf16 serves phase 5c's 8 greedy
    requests on bf16 pools, then on int8 pools (K4 and K5 at head dim
    128); (b) ``gpt3_13b`` built on the card in bf16 (26 GB of weights)
    serves 4 of them on bf16 pools, after (a)'s model is freed, with its
    peak memory printed. Each run: exact launch counts and greedy
    agreement >= 0.9. Returns the launches of (a)'s bf16-pool and (b)'s
    runs summed, and (a)'s int8-pool run's."""
    import gc

    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_13b, gpt3_1p3b

    cfg = gpt3_1p3b()
    trace = [kw for kw in _serving_trace(cfg.vocab_size)
             if kw.get("greedy")][:8]
    model = GPTForCausalLM(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    model.eval()
    a = _bf16_serving(torch, card, model, trace, "5n(a) gpt3_1p3b bf16",
                      (None, "int8"))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    cfg = gpt3_13b()
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    model.eval()
    built = torch.cuda.memory_allocated() / 2**30
    b = _bf16_serving(torch, card, model, trace[:4], "5n(b) gpt3_13b bf16",
                      (None,))
    print(f"5n(b) gpt3_13b: {cfg.num_params()} parameters, "
          f"{built:.2f} GiB allocated once built, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    fp = {k: a[None][k] + b[None][k] for k in a[None]}
    return fp, a["int8"]


# -- phase 8: GPT-MoE and the fused layers ------------------------------------

# the repo's single-chip MoE training workload (benchmarks/baseline_suite.py
# :181-201): batch, sequence, warm-up, timed steps
MOE_BATCH = (8, 1024, 2, 10)
# its parameters: every one, and those one token runs through (the dense
# count, plus in each MoE block a second expert and the gate)
MOE_N_TOTAL = 322_854_960
MOE_N_ACTIVE = 152_847_408
MOE_1P3B_N = 7_357_853_888
# 8b(ii)'s gates on bf16 serving of gpt_moe_1p3b with nothing dropped:
# every row the engine routes to another top-2 expert set than the
# teacher-forced forward does, while no row of its causal past was, is
# a near-tie there (its 2nd and 3rd gate probabilities within
# MOE_FLIP_GAP), and the tokens whose own position routes alike in every
# MoE layer agree with the teacher-forced argmax at least MOE_AGREE
# (phase 5n's limit; PERF.md has the readings)
MOE_FLIP_GAP = 0.05
MOE_AGREE = 0.9
# 8c's engine trace on gpt_moe_tiny (128 positions): prompt lengths
MOE_TINY_PROMPTS = (3, 24, 29, 40, 7, 61)
MOE_TINY_VARIANTS = ("gshard", "switch", "expert_choice", "combine")
FUSED_STACK = (12, 768, 12, 32, 512)     # layers, width, heads, batch, seq
# 8d's gate: each of the flash route's distances from the fp32 run within
# this many times the plain route's. Set between fused_fault_check.py's
# readings (PERF.md): the sound kernels read at most 1.06x on the output,
# the worst gradient and v, but 2.9x and 3.3x on q and k (the flash
# backward's dQ and dK, unexplained); the planted faults at least 5.2x on
# some distance, one warp's dQ atomics skipped only on q (6.1x)
FUSED_RATIO = {"out": 2.0, "grad": 2.0, "q": 4.5, "k": 4.5, "v": 2.0}


def _moe_layers(model):
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer

    return [m for m in model.modules() if isinstance(m, MoELayer)]


def _count_drops(model):
    """Wrap every MoE gate of ``model`` so that each compact plan records
    (rows routed, assignments dropped, second choices random routing
    dropped) as device counts, read only when the caller reads them.
    Returns (records, undo)."""
    recs = []
    gates = [layer.gate for layer in _moe_layers(model)]
    for g in gates:
        plan, routed = g.dispatch_plan, g._routed

        def wrapped_routed(x, routed=routed):
            idx, w, aux = routed(x)
            recs.append(["random", x.shape[0], (idx[:, 1:] < 0).sum()])
            return idx, w, aux

        def wrapped_plan(x, plan=plan, E=g.tot_expert):
            loc, w, C, aux = plan(x)
            recs.append(["plan", x.shape[0], (loc == E * C).sum()])
            return loc, w, C, aux

        g._routed, g.dispatch_plan = wrapped_routed, wrapped_plan

    def undo():
        for g in gates:
            del g._routed, g.dispatch_plan

    return recs, undo


def _drop_totals(recs, rows=None):
    """(plan calls, dropped assignments, of them random-routing drops)
    over the records of ``rows`` routed rows (all when None)."""
    pick = [r for r in recs if rows is None or r[1] == rows]
    plans = [int(r[2]) for r in pick if r[0] == "plan"]
    rand = [int(r[2]) for r in pick if r[0] == "random"]
    return len(plans), sum(plans), sum(rand)


class _Routes:
    """Each MoE gate's routing of every row it scores, keyed by (request
    id, position, MoE layer): the top-2 expert set and the top-3 gate
    probabilities (fp32 softmax of the gate's logits, a forward hook on
    its ``Linear``). Rows are named by ``self.rows`` while a call runs:
    ``wrap(eng)`` names them for the paged engine's prefill chunks and
    decode steps (pad rows and idle slots unnamed), ``teacher`` for a
    teacher-forced forward."""

    def __init__(self, torch, model):
        self.torch, self.model = torch, model
        self.rows, self.calls = None, []
        self.handles = [layer.gate.gate.register_forward_hook(
            lambda mod, inp, out, li=li: self._hook(li, out))
            for li, layer in enumerate(_moe_layers(model))]

    def _hook(self, li, logits):
        if self.rows is not None:
            p = self.torch.softmax(logits.float(), dim=-1)
            val, idx = self.torch.sort(p, dim=-1, descending=True,
                                       stable=True)
            self.calls.append((self.rows, li, idx[:, :2], val[:, :3]))

    def _named(self, rows, fn, *a, **kw):
        self.rows = rows
        try:
            return fn(*a, **kw)
        finally:
            self.rows = None

    def wrap(self, eng):
        """Name the rows of ``eng``'s counted run (a ``_serve`` prepare)."""
        inner = eng.engine
        step, chunk = inner.step, inner.prefill_chunk_at
        self.calls, self.fed = [], {}

        def step_named(toks, t, *a, **kw):
            rows = []
            for i, r in enumerate(eng._slots):
                live = r is not None and eng._pf[i] is None
                rows.append((r.id, int(t[i])) if live else None)
                if live:
                    self.fed[(r.id, int(t[i]))] = int(np.asarray(
                        toks).reshape(-1)[i])
            return self._named(rows, step, toks, t, *a, **kw)

        def chunk_named(ids_row, slot, pos, plen, *a, **kw):
            rid, n = eng._slots[slot].id, min(inner.prefill_chunk, plen - pos)
            for j in range(n):
                self.fed[(rid, pos + j)] = int(ids_row[pos + j])
            rows = [(rid, pos + j) if j < n else None
                    for j in range(inner.prefill_chunk)]
            return self._named(rows, chunk, ids_row, slot, pos, plen, *a,
                               **kw)

        inner.step, inner.prefill_chunk_at = step_named, chunk_named

    def table(self):
        """(request id, position, layer) -> (top-2 set, p2 - p3) of the
        calls so far; clears them."""
        out = {}
        for rows, li, idx, val in self.calls:
            idx, val = idx.cpu().numpy(), val.cpu().numpy()
            for j, key in enumerate(rows):
                if key is not None:
                    out[key + (li,)] = (frozenset(idx[j].tolist()),
                                        float(val[j, 1] - val[j, 2]))
        self.calls = []
        return out

    def report(self, reqs, label):
        """The engine's run (``wrap``) against a teacher-forced forward of
        each request's prompt + tokens[:-1]: every row both route is
        checked; a flip is a row routed to other top-2 experts, primary
        when no row of its causal past flipped. Gates: every primary flip
        a near-tie of the teacher's (p2 - p3 < MOE_FLIP_GAP), and
        agreement >= MOE_AGREE over the tokens whose own position has no
        flip in any layer. Prints the agreement of every token and of
        those with a flip at their position too."""
        torch = self.torch
        served = self.table()
        n_layers = len(self.handles)
        argmax = {}
        with torch.inference_mode():
            for r in reqs:
                ids = list(r.prompt) + r.tokens[:-1]
                rows = [(r.id, p) for p in range(len(ids))]
                logits = self._named(rows, self.model, torch.tensor(
                    [ids], device="cuda"))
                argmax[r.id] = logits[0, len(r.prompt) - 1:].argmax(
                    -1).cpu().numpy()
                check(all(self.fed.get((r.id, p)) == tok
                          for p, tok in enumerate(ids)),
                      f"{label}: the engine's rows name other tokens than "
                      f"request {r.id}'s")
        teacher = self.table()
        check(set(teacher) <= set(served), f"{label}: "
              f"{len(set(teacher) - set(served))} teacher rows the engine "
              "never routed")
        flips = {k: teacher[k][1] for k in teacher
                 if teacher[k][0] != served[k][0]}
        # a flip is primary when no row of its causal past (positions up
        # to its own, lower MoE layers) flipped: its gate's input then
        # differs from the teacher's by rounding alone
        first = {}
        for rid, p, li in flips:
            first[rid, li] = min(p, first.get((rid, li), p))
        primary = [g for (rid, p, li), g in flips.items()
                   if all(first.get((rid, lo), p + 1) > p
                          for lo in range(li))]
        worst = max(primary, default=0.0)
        tally = {"all": [0, 0], "flip here": [0, 0], "none here": [0, 0]}
        for r in reqs:
            for j, tok in enumerate(r.tokens):
                p = len(r.prompt) - 1 + j
                here = any((r.id, p, li) in flips for li in range(n_layers))
                ok = int(argmax[r.id][j] == tok)
                for k in ("all", "flip here" if here else "none here"):
                    tally[k][0] += ok
                    tally[k][1] += 1
        q = np.quantile(primary, [0.5, 0.9]) if primary else (0.0, 0.0)
        print(f"{label}: routing of {len(teacher)} rows (request, position, "
              f"MoE layer) against the teacher-forced forward: {len(flips)} "
              f"flips, {len(primary)} primary; their teacher gaps p2 - p3: "
              f"p50 {q[0]:.4g}, p90 {q[1]:.4g}, max {worst:.4g} (limit "
              f"{MOE_FLIP_GAP}), all flips' max "
              f"{max(flips.values(), default=0.0):.4g}; greedy agreement "
              "with the bf16 argmax: " + "; ".join(
                  f"{k} {a}/{n} = {a / max(n, 1):.4f}"
                  for k, (a, n) in tally.items())
              + f" (limit {MOE_AGREE} where none here)", flush=True)
        check(worst < MOE_FLIP_GAP, f"{label}: a primary flip at a teacher "
              f"gap of {worst} >= {MOE_FLIP_GAP}")
        a, n = tally["none here"]
        check(n > 0 and a / n >= MOE_AGREE, f"{label}: agreement {a}/{n} "
              f"< {MOE_AGREE} over the tokens routed alike")

    def close(self):
        for h in self.handles:
            h.remove()


def _dev_ms(torch, fn, reps: int = 4) -> float:
    """Median device ms of ``fn()`` over ``reps`` calls after one warm
    call (CUDA events around each)."""
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[1:]))


def _kernel_ms(torch, fn) -> float:
    """Device ms of the kernels one call of ``fn()`` launches, after a
    warm call: ``torch.profiler`` (CUPTI), the host's gaps excluded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def _moe_pieces(torch, model, ids, step_ms):
    """8a's step split by piece: each piece's forward and backward timed
    alone at the step's shapes under bf16 AMP (CUDA events over the call,
    and its kernels' device time), times the times a step runs it: the gate and plan, the gather into the (E, C,
    d) buffers, the expert bmms, the combine (one MoE layer each, x6),
    attention (the causal K1/K3a pair, x12) and the head (the tied
    logits and the cross entropy, x1)."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.nn import functional as F

    cfg = model.config
    layers = _moe_layers(model)
    layer = layers[0]
    gate, E = layer.gate, layer.num_expert
    b, s = ids.shape
    S, d = b * s, cfg.hidden_size
    H = cfg.num_heads
    x = torch.randn(S, d, device="cuda")

    def amp():
        return auto_cast(enable=True, dtype="bfloat16")

    with torch.no_grad(), amp():
        loc, w, C, _ = gate.dispatch_plan(x)
    loc = loc.long()
    EC = E * C
    src = torch.full((EC + 1,), S, dtype=torch.long, device="cuda")
    for k in range(loc.shape[1]):
        src[loc[:, k]] = torch.arange(S, device="cuda")
    buf = torch.randn(E, C, d, device="cuda")
    with torch.no_grad(), amp():
        out = layer._apply_stacked(buf)
    g_buf, g_out = torch.randn_like(buf), torch.randn_like(out)
    g_res = torch.randn(S, d, device="cuda", dtype=out.dtype)

    def gate_plan():
        xg = x.detach().requires_grad_()
        with amp():
            _, w_, _, aux = gate.dispatch_plan(xg)
        (w_.float().sum() + aux).backward()

    def gather():
        xg = x.detach().requires_grad_()
        xpad = torch.cat([xg, xg.new_zeros((1, d))])
        xpad.index_select(0, src[:EC]).reshape(E, C, d).backward(g_buf)

    def experts():
        with amp():
            o = layer._apply_stacked(buf.detach().requires_grad_())
        o.backward(g_out)

    def combine():
        o = out.detach().requires_grad_()
        ww = w.detach().requires_grad_()
        outf = torch.cat([o.reshape(EC, -1), o.new_zeros((1, d))])
        res = sum(outf.index_select(0, loc[:, k]) * ww[:, k, None].to(o.dtype)
                  for k in range(loc.shape[1]))
        res.backward(g_res)

    q, k, v = (torch.randn(b, s, H, d // H, device="cuda",
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    g_att = torch.randn(b, s, H, d // H, device="cuda", dtype=torch.bfloat16)

    def attention():
        F.scaled_dot_product_attention(q, k, v, is_causal=True).backward(
            g_att)

    hidden = torch.randn(b, s, d, device="cuda", requires_grad=True)
    wte = model.gpt.wte.weight

    def head():
        with amp():
            hh, ww = maybe_cast_inputs("matmul", (hidden, wte))
            loss = GPTForCausalLM.loss(torch.matmul(hh, ww.t()), ids)
        torch.autograd.grad(loss, (hidden, wte))

    n_moe, L = len(layers), cfg.num_layers
    pieces = [("gate and plan", gate_plan, n_moe), ("gather", gather, n_moe),
              ("expert bmms", experts, n_moe), ("combine", combine, n_moe),
              ("attention (K1 + K3a)", attention, L), ("head", head, 1)]
    parts = [(name, _dev_ms(torch, fn) * times, _kernel_ms(torch, fn) * times)
             for name, fn, times in pieces]
    moe = [sum(p[i] for p in parts[:4]) for i in (1, 2)]
    print(f"8a step by piece (each alone, forward + backward, x its count a "
          f"step: CUDA events over the call, host gaps included / its "
          f"kernels' device time; step p50 {step_ms:.2f} ms): "
          + "; ".join(f"{n} {wall:.2f} / {dev:.2f} ms = {wall / step_ms:.3f}"
                      f" / {dev / step_ms:.3f}" for n, wall, dev in parts)
          + f"; the MoE pieces together {moe[0]:.2f} / {moe[1]:.2f} ms = "
          f"{moe[0] / step_ms:.3f} / {moe[1] / step_ms:.3f}; rows the "
          f"experts compute a layer {EC} for {S * loc.shape[1]} assignments "
          f"(C = {C})", flush=True)
    model.zero_grad(set_to_none=True)


def moe_training_phase(torch, card):
    """Phase 8a: the repo's single-chip MoE training workload
    (``benchmarks/baseline_suite.py:181-201``) on the port, uncut: a
    GPT-2-small backbone (12 layers, hidden 768, vocab 50304) with 8
    gshard top-2 experts in every other block, dropout 0, trained by
    ``ShardedTrainer(loss_fn=model.loss_with_aux, amp=True)`` with AdamW
    at 8 x 1024, 2 warm-up and 10 timed steps: the first loss within 0.5
    of ln 50304 and falling, K1 = K3a = 12 and K2 = 25 a step; tokens/s,
    step p50, MFU over the active and over all parameters, peak memory,
    the assignments a step drops, one profiled step and the step by
    piece. Returns the timed steps' launches."""
    import gc
    import math

    from paddle_tpu_torch.distributed import ShardedTrainer
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                    num_heads=12, max_position_embeddings=1024,
                    hidden_dropout=0.0, attention_dropout=0.0,
                    num_experts=8, moe_top_k=2, moe_gate="gshard",
                    moe_every_k=2)
    batch, seq, warm, steps = MOE_BATCH
    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    layers = _moe_layers(model)
    n_total = sum(p.numel() for p in model.parameters())
    expert = sum(p.numel() for n, p in layers[0].named_parameters()
                 if not n.startswith("gate.")) // cfg.num_experts
    gate = sum(p.numel() for p in layers[0].gate.parameters())
    n_active = cfg.num_params() + len(layers) * (expert + gate)
    check((n_total, n_active) == (MOE_N_TOTAL, MOE_N_ACTIVE),
          f"8a: {n_total} parameters, {n_active} active, expected "
          f"{MOE_N_TOTAL} and {MOE_N_ACTIVE}")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    trainer = ShardedTrainer(model, opt, model.loss_with_aux, amp=True)
    losses, step_ms, total_ms, launches = _timed_steps(
        torch, trainer, (ids, ids), warm, steps, (fa, k2))
    print(f"8a losses: {losses}", flush=True)
    check(all(np.isfinite(losses)), "8a: non-finite training loss")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
          f"8a: first loss {losses[0]} not within 0.5 of ln "
          f"{cfg.vocab_size} = {math.log(cfg.vocab_size):.4f}")
    check(losses[-1] < losses[0], f"8a: loss did not fall: {losses[0]} -> "
          f"{losses[-1]}")
    L = cfg.num_layers
    _check_counts("8a", launches, {"K1": L * steps, "K3a": L * steps,
                                   "K3b-dkv": 0, "K3b-dq": 0,
                                   "K2": (2 * L + 1) * steps})
    perf = _train_perf(torch, card, "8a GPT-MoE (gpt2-small backbone, 8 "
                       "experts every other block) training", n_active,
                       batch * seq, step_ms, total_ms, launches)
    print(f"8a: MFU {perf['mfu']:.4f} over the {n_active} active parameters"
          f", {perf['tokens_per_s'] * 6 * n_total / PEAK_FLOPS['bfloat16']:.4f}"
          f" over all {n_total}", flush=True)
    recs, undo = _count_drops(model)
    trainer.train_step(ids, ids)
    torch.cuda.synchronize()
    undo()
    calls, dropped, rand = _drop_totals(recs)
    assigned = calls * batch * seq * cfg.moe_top_k
    print(f"8a drops a step: {dropped} of {assigned} assignments "
          f"({dropped / assigned:.4f}) over {calls} MoE layers: {rand} "
          f"second choices by random routing, {dropped - rand} by capacity",
          flush=True)
    _profile_step(torch, lambda: trainer.train_step(ids, ids),
                  perf["step_p50_ms"])
    t0 = time.perf_counter()
    trainer.train_step(ids, ids)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    print(f"8a: one step's host enqueue {host_ms:.2f} ms against the step "
          f"p50 {perf['step_p50_ms']:.2f} ms", flush=True)
    _moe_pieces(torch, model, ids, perf["step_p50_ms"])
    del trainer, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_serving_phase(torch, card):
    """Phase 8b: ``gpt_moe_1p3b`` (24 layers, hidden 2048, 16 heads of
    128, 16 gshard experts in every other block: 7,357,853,888
    parameters) built on the card in bf16 at full width and depth serves
    phase 5c's 8 greedy requests on bf16 pools, then on int8 pools:

    (i) at its eval capacity (C = 4 at the 8 decode slots): exact
    launches; the assignments dropped in decode and in prefill, the
    decode step p50; the agreement with the teacher-forced argmax
    printed (a forward over a whole sequence routes under another
    capacity, so it drops other assignments);
    (ii) with every gate's capacity at E / top_k (C >= the rows of any
    call: nothing dropped, checked): exact launches, and each run's
    routing against a teacher-forced forward's (``_Routes.report``): a
    routing choice decided by a bf16 rounding moves a token's whole
    expert output, so two bf16 computations of the same function agree
    less than a dense model's do, and the gates hold what does not
    depend on such a choice: every row routed otherwise is a near-tie,
    and the tokens routed alike agree at least MOE_AGREE;
    (iii) the same weights upcast to fp32 in place (exact) at capacity E
    / top_k on fp32 pools: every greedy token the teacher-forced argmax
    but at a near-tie (gap < 1e-3), as phase 5 holds gpt2_small, and
    (ii)'s tokens against this fp32 argmax printed.

    Prints the peak memory of the bf16 runs and of the fp32 one. Returns
    the launches of the bf16-pool runs, of the int8-pool runs and of the
    fp32 run."""
    import gc

    from paddle_tpu_torch.models import GPTForCausalLM, gpt_moe_1p3b

    cfg = gpt_moe_1p3b()
    trace = [kw for kw in _serving_trace(cfg.vocab_size)
             if kw.get("greedy")][:8]
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    model.eval()
    built = torch.cuda.memory_allocated() / 2**30
    n = sum(p.numel() for p in model.parameters())
    check(n == MOE_1P3B_N, f"8b: {n} parameters, expected {MOE_1P3B_N}")
    print(f"8b gpt_moe_1p3b: {n} parameters, {built:.2f} GiB allocated once "
          "built in bf16", flush=True)
    layers = _moe_layers(model)
    recs, undo = _count_drops(model)
    top_k = cfg.moe_top_k
    roomy = [False]
    served = {}

    def after(label, agg, reqs):
        if roomy[0] and reqs is not None:
            served[label] = reqs
        steps = int(agg["decode_steps"])
        calls, dropped, _ = _drop_totals(recs, rows=8)
        check(calls == steps * len(layers),
              f"{label}: {calls} decode plans for {steps} steps")
        p_calls, p_dropped, _ = _drop_totals(recs, rows=128)
        print(f"{label}: decode dropped {dropped} of {calls * 8 * top_k} "
              f"assignments ({dropped / max(calls * 8 * top_k, 1):.4f}; C = "
              f"{layers[0].gate._cap(8)} at 8 slots), prefill chunks "
              f"{p_dropped} of {p_calls * 128 * top_k}; decode step p50 "
              f"{agg['decode_step_ms_p50']:.2f} ms (the drop counts add "
              "four small launches a MoE layer)", flush=True)
        check(not roomy[0] or dropped + p_dropped == 0,
              f"{label}: {dropped + p_dropped} assignments dropped at "
              "capacity E / top_k")

    own = _bf16_serving(torch, card, model, trace,
                        "8b(i) gpt_moe_1p3b bf16, eval capacity",
                        (None, "int8"), prepare=lambda eng: recs.clear(),
                        after=after, min_agree=None)
    roomy[0] = True
    cap = cfg.num_experts / top_k
    for layer in layers:
        layer.gate.capacity = (cap, cap)
    routes = _Routes(torch, model)

    def prepare(eng):
        recs.clear()
        routes.wrap(eng)

    def after_routed(label, agg, reqs):
        after(label, agg, reqs)
        routes.report(reqs, label)

    wide = _bf16_serving(torch, card, model, trace,
                         f"8b(ii) gpt_moe_1p3b bf16, capacity {cap:g}",
                         (None, "int8"), prepare=prepare,
                         after=after_routed, min_agree=None)
    routes.close()
    print(f"8b gpt_moe_1p3b bf16: peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    model.float()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, reqs, agg, wall, fp32 = _serve(torch, model, trace,
                                      prepare=lambda eng: recs.clear())
    after("8b(iii) gpt_moe_1p3b fp32", agg, None)
    _check_launches("8b(iii) gpt_moe_1p3b fp32", fp32, cfg.num_layers,
                    int(agg["prefill_chunks"]), int(agg["decode_steps"]),
                    int8=False)
    undo()
    _greedy_consistency(torch, model, reqs,
                        f"8b(iii) gpt_moe_1p3b fp32, capacity {cap:g}")
    for label, ran in served.items():
        agree, total = _agreement(torch, model, ran)
        print(f"{label}: greedy agreement with the fp32 argmax of the same "
              f"weights {agree}/{total} = {agree / total:.4f}", flush=True)
    print(_perf_line("8b(iii) gpt_moe_1p3b fp32", card, agg, wall),
          flush=True)
    print(f"8b gpt_moe_1p3b fp32: peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del model, served
    gc.collect()
    torch.cuda.empty_cache()
    return ({k: own[None][k] + wide[None][k] for k in own[None]},
            {k: own["int8"][k] + wide["int8"][k] for k in own["int8"]},
            fp32)


def _moe_tiny_pair(torch, cfg, seed, variant=None):
    """gpt_moe_tiny on the CPU and the same weights on the card; for
    ``variant`` "expert_choice" every MoE gate is an ExpertChoiceGate
    with the gate's weights. Random routing off and Switch's jitter at
    eps 0, so both devices route from the same numbers."""
    from paddle_tpu_torch.incubate.distributed.models.moe import \
        ExpertChoiceGate
    from paddle_tpu_torch.models import GPTForCausalLM

    pair = []
    for dev in ("cpu", "cuda"):
        m = GPTForCausalLM(cfg, device=dev, seed=seed)
        for layer in _moe_layers(m):
            if variant == "expert_choice":
                g = ExpertChoiceGate(cfg.hidden_size, cfg.num_experts,
                                     device=dev)
                g.set_state_dict({k: v.detach().cpu().numpy() for k, v in
                                  layer.gate.state_dict().items()})
                layer.gate = g
            if hasattr(layer.gate, "random_routing"):
                layer.gate.random_routing = False
            if hasattr(layer.gate, "switch_eps"):
                layer.gate.switch_eps = 0.0
        pair.append(m)
    pair[1].set_state_dict({k: v.numpy()
                            for k, v in pair[0].state_dict().items()})
    return pair


def _tiny_serve(torch, model, device, reqs_kw):
    from paddle_tpu_torch.inference import Request, ServingEngine

    eng = ServingEngine(model, max_batch_slots=2, max_len=128,
                        block_size=16, prefill_chunk=16, top_k=1,
                        device=device)
    reqs = [eng.submit(Request(**kw)) for kw in reqs_kw]
    agg = eng.run(max_steps=2000).aggregate()
    check(all(r.status == "done" for r in reqs), f"8c: {device} requests "
          "did not finish")
    return [r.tokens for r in reqs], agg


def moe_tiny_phase(torch, card):
    """Phase 8c: ``gpt_moe_tiny`` holds its CPU result on the card. (a)
    The paged engine (2 slots, chunks and blocks of 16) serves
    MOE_TINY_PROMPTS greedily at the default capacity and at factor 0.5
    (prefill chunks drop): the card's tokens equal the CPU's exactly,
    launches exact. (b) One fp32 training step (2 x 128: K1/K3a on the
    card) for the gshard, Switch and expert-choice gates and the combine
    route: ``loss_with_aux`` and every gradient within 7b's FLASH_TOL
    bounds of the CPU's from the same weights; then
    ``ClipGradForMOEByGlobalNorm`` on the card's gradients: its
    coefficient within 1e-6 of the same clip on the CPU and of the fp64
    formula. Returns the launches."""
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm, moe_dispatch_mode)
    from paddle_tpu_torch.models import gpt_moe_tiny
    from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2
    from paddle_tpu_torch.ops.kernels import paged_attention as k4

    rs = np.random.RandomState(80)
    reqs_kw = [dict(prompt=rs.randint(0, 256, n).tolist(), max_new_tokens=16,
                    greedy=True) for n in MOE_TINY_PROMPTS]
    total = {"K1": 0, "K3a": 0, "K2": 0, "K4": 0, "K5": 0}
    for cap in (None, 0.5):
        cfg = gpt_moe_tiny()
        cfg.moe_capacity_factor = cap
        cpu, dev = _moe_tiny_pair(torch, cfg, seed=5)
        want, _ = _tiny_serve(torch, cpu, "cpu", reqs_kw)
        recs, undo = _count_drops(dev)
        for m in (k2, k4, k5):
            m.reset_launches()
        got, agg = _tiny_serve(torch, dev, "cuda", reqs_kw)
        torch.cuda.synchronize()
        undo()
        launches = {"K2": k2.launches, "K4": k4.launches, "K5": k5.launches,
                    "K4-int8": k4.launches_q, "K5-int8": k5.launches_q}
        _check_launches(f"8c cap {cap}", launches, cfg.num_layers,
                        int(agg["prefill_chunks"]), int(agg["decode_steps"]),
                        int8=False)
        _, dropped, _ = _drop_totals(recs, rows=16)
        diff = sum(a != b for a, b in zip(got, want))
        print(f"8c gpt_moe_tiny served at capacity factor {cap}: "
              f"{len(got)} requests, {sum(map(len, got))} tokens, {diff} "
              f"differ from the CPU's; prefill chunks dropped {dropped} "
              f"assignments; launches {launches}", flush=True)
        check(got == want, f"8c cap {cap}: the card's tokens {got} != the "
              f"CPU's {want}")
        check((dropped > 0) == (cap == 0.5), f"8c cap {cap}: {dropped} "
              "assignments dropped in prefill")
        for k in ("K2", "K4", "K5"):
            total[k] += launches[k]

    L = 2
    lim_loss = 2 * FLASH_TOL["float32"] * L ** 0.5
    lim_grad = 2 * FLASH_TOL["float32"] * (2 * L) ** 0.5
    ids = torch.from_numpy(np.random.RandomState(81).randint(0, 256,
                                                             (2, 128)))
    for variant in MOE_TINY_VARIANTS:
        cfg = gpt_moe_tiny()
        if variant == "switch":
            cfg.moe_gate, cfg.moe_top_k = "switch", 1
        cpu, dev = _moe_tiny_pair(torch, cfg, seed=6, variant=variant)
        res = []
        for m in (cpu, dev):
            m.train()
            x = ids.to(next(m.parameters()).device)
            fa.reset_launches()
            k2.reset_launches()
            with moe_dispatch_mode("allreduce" if variant == "combine"
                                   else "alltoall"):
                loss = m.loss_with_aux(m(x), x)
            names = [n for n, _ in m.named_parameters()]
            grads = torch.autograd.grad(loss, [p for p in m.parameters()])
            res.append((float(loss), [g.detach().cpu() for g in grads]))
        torch.cuda.synchronize()
        launches = {"K1": fa.launches["fwd"], "K3a": fa.launches["bwd_fused"],
                    "K2": k2.launches}
        _check_counts(f"8c {variant}", launches,
                      {"K1": L, "K3a": L, "K2": 2 * L + 1})
        for k in launches:
            total[k] += launches[k]
        (lc, gc_), (ld, gd) = res
        rel = abs(ld - lc) / abs(lc)
        norms = torch.stack([g.norm() for g in gc_])
        floor = norms.norm() / len(names) ** 0.5
        worst, worst_name = 0.0, None
        for n, a, b, gn in zip(names, gd, gc_, norms):
            r = float((a - b).norm() / torch.maximum(gn, floor))
            if r > worst:
                worst, worst_name = r, n
        print(f"8c {variant}: training loss card {ld!r}, CPU {lc!r}, relative "
              f"{rel:.3g} (limit {lim_loss:.3g}); worst gradient "
              f"{worst_name} {worst:.3g} in norm (limit {lim_grad:.3g}); "
              f"launches {launches}", flush=True)
        check(rel <= lim_loss, f"8c {variant}: loss {ld} vs {lc}")
        check(worst <= lim_grad, f"8c {variant}: gradient {worst_name} "
              f"differs by {worst}")
        if variant != "gshard":
            continue
        params = list(dev.parameters())
        pairs = list(zip(params, [g.cuda() for g in gd]))
        clip = ClipGradForMOEByGlobalNorm(1e-3)
        coef_dev = float(clip(pairs)[0][1].double().norm()
                         / pairs[0][1].double().norm())
        cpu_pairs = list(zip(params, gd))
        coef_cpu = float(clip(cpu_pairs)[0][1].double().norm()
                         / gd[0].double().norm())
        norm64 = float(sum(g.double().square().sum() for g in gd) ** 0.5)
        coef64 = min(1.0, 1e-3 / norm64)
        print(f"8c clip: coefficient on the card {coef_dev!r}, on the CPU "
              f"{coef_cpu!r}, fp64 formula {coef64!r} (global norm "
              f"{norm64:.6g}; limit 1e-6 relative)", flush=True)
        check(abs(coef_dev - coef_cpu) <= 1e-6 * coef_cpu
              and abs(coef_dev - coef64) <= 1e-6 * coef64,
              f"8c clip: coefficient {coef_dev} vs {coef_cpu}, {coef64}")
    return total


def fused_readings(torch):
    """Phase 8d's readings: a stack of 12 ``FusedTransformerEncoderLayer``s
    (768 wide, 12 heads, FFN 3072, post-norm, dropout 0) at 32 x 512,
    forward and backward of ``(h * w).sum()`` (``w`` a seeded random
    tensor of the output's shape, so every parameter's gradient runs
    through every attention above it), three times from the same weights
    and input: under bf16 AMP on the flash route (no mask: K1 = K3a =
    12, K2 = 24), under bf16 AMP on the plain route (an all-zero additive
    mask: K1 = K3a = 0), and in fp32 on the plain route (the exact run,
    TF32 off). For each bf16 route: the output's relative distance from
    the exact run's (``out``), every parameter gradient's (in norm, over
    the larger of its exact norm and the RMS of all) and their largest
    (``grad``), the largest over the layers of the q, k and v columns of
    the packed projection's weight gradient, each in its own norm
    (``q``, ``k``, ``v``: only attention's backward reaches them, and
    at this init dQ and dK are a small part of the whole), its launches
    and its device ms (forward + backward)."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    L, d, H, b, s = FUSED_STACK
    torch.manual_seed(0)
    stack = torch.nn.ModuleList([FusedTransformerEncoderLayer(
        d, H, 4 * d, dropout_rate=0.0, device="cuda") for _ in range(L)])
    stack.train()
    params = list(stack.parameters())
    names = [n for n, _ in stack.named_parameters()]
    x = torch.randn(b, s, d, device="cuda")
    w = torch.randn(b, s, d, device="cuda")
    zero = torch.zeros(b, 1, 1, s, device="cuda")

    def run(mask, amp):
        with auto_cast(enable=amp, dtype="bfloat16"):
            h = x
            for layer in stack:
                h = layer(h, mask)
            loss = (h.float() * w).sum()
        return h.detach().float(), torch.autograd.grad(loss, params)

    runs = {}
    for route, mask, amp in (("flash", None, True), ("plain", zero, True),
                             ("exact", zero, False)):
        fa.reset_launches()
        k2.reset_launches()
        h, grads = run(mask, amp)
        torch.cuda.synchronize()
        launches = {"K1": fa.launches["fwd"], "K3a": fa.launches["bwd_fused"],
                    "K2": k2.launches}
        ms = _dev_ms(torch, lambda: run(mask, amp), reps=3) if amp else None
        runs[route] = (h, [g.float() for g in grads], launches, ms)
    eh, eg = runs["exact"][:2]
    norms = torch.stack([g.norm() for g in eg])
    floor = norms.norm() / len(names) ** 0.5
    out = {"launches": {}, "ms": {}, "out": {}, "grad": {}, "q": {},
           "k": {}, "v": {}, "worst": {}}
    packed = [i for i, n in enumerate(names) if n.endswith("qkv_proj.weight")]

    def part(g, j):
        # the per-head packed columns: (d, H, [q | k | v], head dim)
        return g.view(d, H, 3, d // H)[:, :, j]
    for route in ("flash", "plain"):
        h, grads, launches, ms = runs[route]
        finite = bool(torch.isfinite(h).all()) and all(
            bool(torch.isfinite(g).all()) for g in grads)
        errs = [float((g - e).norm() / torch.maximum(en, floor))
                for g, e, en in zip(grads, eg, norms)] if finite else \
            [float("inf")] * len(names)
        i = int(np.argmax(errs))
        out["launches"][route] = launches
        out["ms"][route] = ms
        out["out"][route] = float((h - eh).norm() / eh.norm()) if finite \
            else float("inf")
        out["grad"][route] = errs[i]
        out["worst"][route] = names[i]
        for j, key in enumerate("qkv"):
            out[key][route] = max(
                float((part(grads[i], j) - part(eg[i], j)).norm()
                      / part(eg[i], j).norm()) if finite else float("inf")
                for i in packed)
    return out


def fused_failures(r) -> list:
    """What phase 8d's gate finds wrong in ``fused_readings``: exact
    launches on each route, and the flash route's distances from the
    exact run (output, largest gradient, largest q, k and v gradient)
    each within its FUSED_RATIO times the plain route's, both bf16
    computations of the same function."""
    L = FUSED_STACK[0]
    bad = []
    want = {"flash": {"K1": L, "K3a": L, "K2": 2 * L},
            "plain": {"K1": 0, "K3a": 0, "K2": 2 * L}}
    for route, counts in want.items():
        if r["launches"][route] != counts:
            bad.append(f"{route} launches {r['launches'][route]}, expected "
                       f"{counts}")
    for key, ratio in FUSED_RATIO.items():
        fl, pl = r[key]["flash"], r[key]["plain"]
        if not fl <= ratio * pl:
            bad.append(f"{key}: the flash route's distance {fl:.3g} from "
                       f"the exact run is over {ratio} x the plain "
                       f"route's {pl:.3g}")
    return bad


def fused_phase(torch, card):
    """Phase 8d: ``fused_readings`` through ``fused_failures``. Returns the
    flash route's launches."""
    r = fused_readings(torch)
    L, d, H, b, s = FUSED_STACK
    print(f"8d fused encoder stack ({L} x {d}, {H} heads, {b} x {s}, bf16 "
          f"AMP) on {card}: flash route {r['ms']['flash']:.2f} ms forward + "
          f"backward, plain route {r['ms']['plain']:.2f} ms; distance from "
          "the fp32 run, flash / plain (limit FUSED_RATIO x plain, "
          f"{FUSED_RATIO}): output {r['out']['flash']:.3g} / "
          f"{r['out']['plain']:.3g}, worst gradient {r['grad']['flash']:.3g}"
          f" ({r['worst']['flash']}) / {r['grad']['plain']:.3g} "
          f"({r['worst']['plain']}), worst q, k, v weight gradients "
          + ", ".join(f"{r[k]['flash']:.3g} / {r[k]['plain']:.3g}"
                      for k in "qkv") + "; launches "
          f"flash {r['launches']['flash']}, plain {r['launches']['plain']}",
          flush=True)
    bad = fused_failures(r)
    check(not bad, "8d: " + "; ".join(bad))
    return r["launches"]["flash"]


# -- phase 8e: gpt2_small trained over a mesh of ranks ---------------------------

# fp32 parity of the mesh runs (8e (b)-(e)) against the one-process run
# on the same card, weights and batch: the losses relatively, every
# parameter after 3 AdamW steps absolutely (Adam's first steps are ~lr
# whatever the gradient's scale, so a parameter whose gradient sums to
# ~0 may step either way when the sums run in another order). Over two
# runs on an H100 the sound meshes' worst are a loss 9.26e-8 off (one
# fp32 ulp at ~10) and a parameter 1.29e-5 off (dp 2; the others 7.6e-6
# to 1.13e-5), PERF.md: the limits sit 4.3x and 3.9x above. The
# CPU tests' planted faults (tests/test_torch_mesh_trainer.py) move the
# parameters by ~6 lr in 3 steps, 6e-4 at this lr.
MESH_LOSS_RTOL = 4e-7
MESH_PARAM_ATOL = 5e-5
MESH_GANGS = ((2, ("b", "c", "d2", "d3")), (4, ("e",)))
MESH_GANG_TIMEOUT_S = 300.0


def _run_gang(script, nproc, out, cases, phase):
    """``script`` in ``nproc`` ranks through the port's launcher, its
    workers in a session of their own, killed whole past the timeout."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    logs = os.path.join(out, f"logs{nproc}")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--log_dir", logs,
           os.path.join(root, script), out, *cases]
    proc = subprocess.Popen(cmd, cwd=root, start_new_session=True)
    try:
        rc = proc.wait(timeout=MESH_GANG_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    if rc != 0:
        text = "".join(open(os.path.join(logs, f)).read()[-3000:]
                       for f in sorted(os.listdir(logs)))
        fail(f"{phase}: the {nproc}-rank gang {cases} ended {rc}:\n{text}")


def mesh_phase(torch, card):
    """Phase 8e: ``gpt2_small`` at full width and depth over meshes of
    ranks (``mesh_gang.py``). (a) One rank on NCCL through
    ``fleet.init`` and ``ShardedTrainer(mesh=)``, in lockstep with the
    one-process run (``mesh=None``), the same gradients fed to both
    updates (``_GradTap``): losses and parameters bitwise. (b)-(e) gangs
    of 2 and 4 ranks on this card over gloo (dp 2, mp 2, ZeRO-2 and
    ZeRO-3 over sharding 2, dp 2 x mp 2): 3 fp32 steps held to the
    one-process run (MESH_LOSS_RTOL, MESH_PARAM_ATOL), each rank's K1,
    K3a and K2 launches exact, and the bf16 AMP step time. Then (e)'s
    checkpoint loads into one process, whose next loss must be (e)'s.
    Returns the launches of every rank's counted steps."""
    import gc
    import tempfile

    import mesh_gang
    from paddle_tpu_torch.distributed import env, fleet, gloo_release
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    cfg = gpt2_small()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    L, steps = cfg.num_layers, mesh_gang.STEPS
    ids = torch.from_numpy(mesh_gang.batch_ids(cfg.vocab_size)).cuda()
    out = tempfile.mkdtemp(prefix="mesh-8e-")
    total = {"K1": 0, "K3a": 0, "K2": 0}

    def want(n):
        return {"K1": L * n, "K3a": L * n, "K3b": 0, "K2": (2 * L + 1) * n}

    # (a): one-rank NCCL beside mesh=None, fp32, in lockstep
    fa.reset_launches()
    k2.reset_launches()
    ref = mesh_gang.make_trainer(torch, cfg, wrap=_GradTap)
    init_parallel_env(f"file://{out}/nccl-store", 1, 0, backend="nccl")
    fleet.init(is_collective=True)
    check(fleet.get_mesh().size == 1 and torch.distributed.get_backend()
          == "nccl", "8e (a): not a one-rank NCCL mesh")
    one = mesh_gang.make_trainer(
        torch, cfg, mesh=fleet.get_mesh(),
        wrap=lambda o: _GradTap(o, source=ref.optimizer))
    ref_losses = []
    for i in range(steps):
        lr_, la = ref.train_step(ids, ids), one.train_step(ids, ids)
        check(torch.equal(lr_, la), f"8e (a): step {i + 1} loss "
              f"{float(la)!r} != mesh=None {float(lr_)!r}")
        ref_losses.append(float(lr_))
    for (n, p), q in zip(ref.model.named_parameters(),
                         one.model.parameters()):
        check(torch.equal(p, q), f"8e (a): parameter {n} differs")
    got = _counts(fa, k2)
    check(got == want(2 * steps), f"8e (a) launches {got} != "
          f"{want(2 * steps)}")
    for k in total:
        total[k] += got[k]
    torch.save({"losses": ref_losses,
                "params": {n: p.detach().cpu() for n, p in
                           ref.model.named_parameters()}},
               os.path.join(out, "ref.pt"))
    print(f"8e (a) one-rank NCCL mesh through fleet.init on {card}: losses "
          f"{ref_losses} bitwise mesh=None's, every parameter bitwise",
          flush=True)
    del ref, one
    gc.collect()
    torch.cuda.empty_cache()

    # (b)-(e): gloo gangs on this card
    results = {}
    for nproc, cases in MESH_GANGS:
        t0 = time.perf_counter()
        _run_gang("mesh_gang.py", nproc, out, cases, "8e")
        print(f"8e: the {nproc}-rank gang {cases}: "
              f"{time.perf_counter() - t0:.1f} s wall", flush=True)
        for name in cases:
            results[name] = [json.load(open(os.path.join(
                out, f"{name}.rank{r}.json"))) for r in range(nproc)]
    for name, ranks in results.items():
        r0 = ranks[0]
        for r, res in enumerate(ranks):
            check(res["fp32_launches"] == want(steps)
                  and res["bf16_launches"] == want(mesh_gang.TIMED),
                  f"8e ({name}) rank {r}: launches {res['fp32_launches']} "
                  f"(fp32), {res['bf16_launches']} (bf16) != "
                  f"{want(steps)}, {want(mesh_gang.TIMED)}")
            check(res["losses"] == r0["losses"],
                  f"8e ({name}): rank {r}'s losses differ from rank 0's")
            for k in total:
                total[k] += res["fp32_launches"][k] + res["bf16_launches"][k]
        print(f"8e ({name}) mesh {r0['mesh']} ZeRO {r0['stage']}, "
              f"{len(ranks)} ranks on {card}, fp32: losses {r0['losses']}; "
              f"distance from one process: loss {r0['loss_rel']:.3g} "
              f"(limit {MESH_LOSS_RTOL}), parameters {r0['param_abs']:.3g} "
              f"(limit {MESH_PARAM_ATOL}); bf16 AMP step "
              f"{float(np.median(r0['bf16_step_ms'])):.1f} ms p50 of "
              f"{[round(x, 1) for x in r0['bf16_step_ms']]} (gloo through "
              f"host, not a measure of NCCL), peak {max(x['peak_gib'] for x in ranks):.2f} "
              f"GiB a rank; launches a rank fp32 {r0['fp32_launches']}, "
              f"bf16 {r0['bf16_launches']}", flush=True)
        check(r0["loss_rel"] <= MESH_LOSS_RTOL
              and r0["param_abs"] <= MESH_PARAM_ATOL,
              f"8e ({name}): fp32 distance from one process {r0['loss_rel']}"
              f", {r0['param_abs']} over the limits")

    # (e)'s checkpoint into one process: the same next loss
    fa.reset_launches()
    k2.reset_launches()
    back = mesh_gang.make_trainer(torch, cfg)
    back.load_checkpoint(os.path.join(out, "ckpt_e"))
    nxt = float(back.train_step(ids, ids))
    e_next = results["e"][0]["next_loss"]
    rel = abs(nxt - e_next) / abs(e_next)
    print(f"8e: (e)'s 4-rank checkpoint in one process: next loss {nxt!r} "
          f"against (e)'s {e_next!r}, relative {rel:.3g} (limit "
          f"{MESH_LOSS_RTOL})", flush=True)
    check(back.step_count == steps + 1 and rel <= MESH_LOSS_RTOL,
          f"8e: (e)'s checkpoint gives next loss {nxt} != {e_next}")
    got = _counts(fa, k2)
    for k in total:
        total[k] += got[k]
    del back
    gloo_release()
    fleet.fleet_state().__init__()
    env.set_mesh(None)
    gc.collect()
    torch.cuda.empty_cache()
    return total


# Phase 8f's limits. The pipelined and sequence-cut runs sum in other
# orders than the one-process run (microbatch means, the pp sum of the
# tied embedding's gradient, the ring's per-block merge), so a loss and
# the clip's global norm are held relatively and a parameter after the
# SGD steps absolutely. SGD, and a clip that never engages, keep a
# gradient's scale in the parameters (AdamW's step is blind to it), so
# a gradient off by a factor of 2 (sep averaged, a dp average dropped)
# moves a parameter by about half the reference's largest move (on an
# H100 80GB HBM3 at 700.00 W, PERF.md: gpt2_small 8.79e-3 in 3 steps,
# bert-base 8.05e-3 in 2). The worst sound readings there: losses
# 9.17e-8, norms 5.75e-7, parameters 1.19e-7; the limits sit 10.9x,
# 7.0x and 8.4x above. The ring's and Ulysses' bf16 outputs and gradients are held to
# one rank's flash attention, max |difference| over max |reference|.
# PIPE_MEM_RATIO bounds a rank's peak memory at M 8 over M 4
# (microbatches of 2 rows): the 1F1B schedule keeps 2W - 1 boundary
# activations whatever M is.
PIPE_LOSS_RTOL = 1e-6
PIPE_PARAM_ATOL = 1e-6
PIPE_NORM_RTOL = 4e-6
PIPE_ATTN_RTOL = 2e-2
PIPE_MEM_RATIO = 1.10
PIPE_GANGS = ((2, ("attn", "mem", "b", "c", "e_ring", "e_ulysses",
                   "e_ulysses_rc", "f")),
              (4, ("d",)))


def _pipe_want(case, r, nproc, L, M, V, n, first_step):
    """Each rank's K1, K3a and K2 launches over ``n`` steps of a phase
    8f case. 1F1B on pp rank s of S = 2 (``Lc = L / (S V)`` blocks a
    chunk): a chunk's blocks run forward twice a microbatch (the forward
    sub-tick, without a graph, and the recompute) and backward once,
    but the loss chunk (the last virtual stage, on rank S-1) runs only
    its recompute, so K1 = M Lc (2V - [s = S-1]), K3a = M Lc V; K2 =
    2 K1 for the two norms a block, plus ``last``'s norm once a
    microbatch on rank S-1 (GPT's ``ln_f``, BERT's MLM head's) and, for
    BERT, the embeddings' norm twice a microbatch on rank 0, and once
    more on every rank in a model's first step (``first`` run on one
    row to learn the activation's shape; GPT's ``first`` has no norm).
    Ring attention on sep rank r (causal): K1 and K3a once a visible
    block, (r + 1) L; Ulysses: L; K2 2L + 1 either way; the per-block
    recompute (``_rc``) runs each block's forward twice: K1 2L, K2
    4L + 1."""
    if case in ("b", "c", "d", "f"):
        S, s = 2, r % 2               # [dp, pp]: pp is the fast index
        Lc, last = L // (S * V), s == S - 1
        k1 = M * Lc * (2 * V - last)
        k2 = 2 * k1 + (M if last else 0)
        if case == "f":
            k2 += 0 if last else 2 * M
        return {"K1": k1 * n, "K3a": M * Lc * V * n, "K3b": 0,
                "K2": k2 * n + (case == "f" and first_step)}
    blocks = (r + 1) * L if case == "e_ring" else L
    rc = 2 if case.endswith("_rc") else 1
    return {"K1": rc * blocks * n, "K3a": blocks * n, "K3b": 0,
            "K2": (2 * rc * L + 1) * n}


def pipe_phase(torch, card):
    """Phase 8f: the pipeline and the sequence axis over ranks
    (``pipe_gang.py``), ``gpt2_small`` at full width and depth. (a) One
    NCCL rank: ``GPTForCausalLMPipe(num_stages=1)`` through
    ``fleet.init``, in lockstep with ``mesh=None`` (the same gradients
    fed to both updates, ``_GradTap``): losses and parameters bitwise.
    Then the one-process references (``GPTForCausalLM`` from the same
    seed, the Pipe models' weights; bert-base's Pipe on one rank) and
    gangs of 2 and 4 ranks on this card over gloo: (b) pp 2, M 4; (c)
    pp 2, V 2, M 4; (d) dp 2 x pp 2; (e) sep 2 ring, Ulysses, and
    Ulysses with every block recomputed; (f) bert-base pp 2, M 4. Their
    fp32 SGD steps' losses, global norms and parameters within
    PIPE_LOSS_RTOL, PIPE_NORM_RTOL and PIPE_PARAM_ATOL of the reference
    (SGD, and a clip that never engages, so a gradient off by a factor
    shows; the reference's parameter movement says by how much), every
    rank's
    K1, K3a and K2 launches as ``_pipe_want`` says, the bf16 AMP step
    times printed; ring's and Ulysses' attention within PIPE_ATTN_RTOL
    of the flash attention; the peak memory flat in M. Returns the
    launches of the counted steps."""
    import gc
    import tempfile

    import pipe_gang
    from paddle_tpu_torch.distributed import (ShardedTrainer, env, fleet,
                                              gloo_release,
                                              init_parallel_env)
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as k2

    cfg = gpt2_small()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    L, steps = cfg.num_layers, pipe_gang.STEPS
    dev = torch.device("cuda", torch.cuda.current_device())
    ids = torch.from_numpy(pipe_gang.batch_ids(cfg.vocab_size)).cuda()
    out = tempfile.mkdtemp(prefix="pipe-8f-")
    total = {"K1": 0, "K3a": 0, "K2": 0}

    def add(got):
        for k in total:
            total[k] += got[k]

    dense = {"K1": L, "K3a": L, "K3b": 0, "K2": 2 * L + 1}
    # (a): a one-stage Pipe on one NCCL rank beside mesh=None, in lockstep
    fa.reset_launches()
    k2.reset_launches()
    ref_pipe = pipe_gang.gpt_pipe(torch, cfg, 1, 1, 1)
    ref = ShardedTrainer(ref_pipe, _GradTap(pipe_gang.adamw(ref_pipe)),
                         type(ref_pipe).loss)
    init_parallel_env(f"file://{out}/nccl-store", 1, 0, backend="nccl")
    fleet.init(is_collective=True)
    check(fleet.get_mesh().size == 1 and torch.distributed.get_backend()
          == "nccl", "8f (a): not a one-rank NCCL mesh")
    one_pipe = pipe_gang.gpt_pipe(torch, cfg, 1, 1, 1)
    one = ShardedTrainer(one_pipe, _GradTap(pipe_gang.adamw(one_pipe),
                                            source=ref.optimizer),
                         type(one_pipe).loss, mesh=fleet.get_mesh())
    pipe_losses = []
    for i in range(steps):
        lr_, la = ref.train_step(ids, ids), one.train_step(ids, ids)
        check(torch.equal(lr_, la), f"8f (a): step {i + 1} loss "
              f"{float(la)!r} != mesh=None {float(lr_)!r}")
        pipe_losses.append(float(lr_))
    for (n, p), q in zip(ref_pipe.named_parameters(), one_pipe.parameters()):
        check(torch.equal(p, q), f"8f (a): parameter {n} differs")
    got = _counts(fa, k2)
    want = {k: v * 2 * steps for k, v in dense.items()}
    check(got == want, f"8f (a) launches {got} != {want}")
    add(got)
    print(f"8f (a) GPTForCausalLMPipe(num_stages=1) on one NCCL rank "
          f"through fleet.init on {card}: losses {pipe_losses} bitwise "
          f"mesh=None's, every parameter bitwise", flush=True)
    del ref, one, ref_pipe, one_pipe
    gc.collect()
    torch.cuda.empty_cache()

    # the one-process references the gangs are held to
    fa.reset_launches()
    k2.reset_launches()
    def reference(model, loss_fn, batch, n, path):
        """One process's SGD steps: losses, the clip's global norms, the
        parameters, and the largest distance a parameter moved."""
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        opt = pipe_gang.sgd(model)
        tr = ShardedTrainer(model, opt, loss_fn)
        losses = [float(tr.train_step(*batch)) for _ in range(n)]
        norms = pipe_gang.norms_of(opt)
        moved = max(float((p.detach() - start[k]).abs().max())
                    for k, p in model.named_parameters())
        check(max(norms) < pipe_gang.SGD_CLIP, f"8f reference: the clip "
              f"engaged (global norms {norms})")
        torch.save({"losses": losses, "norms": norms,
                    "params": {k: p.detach().cpu() for k, p in
                               model.named_parameters()}}, path)
        return losses, norms, moved

    model = GPTForCausalLM(cfg, device=dev, seed=0)
    model.train()
    ref_losses, ref_norms, moved = reference(
        model, None, (ids, ids), steps, os.path.join(out, "ref.pt"))
    del model
    bert = pipe_gang.bert_pipe(torch, 2, 4)
    bids, blabels = (torch.from_numpy(a).cuda()
                     for a in pipe_gang.bert_batch(30522))
    bert_losses, bert_norms, bert_moved = reference(
        bert, bert.mlm_loss, (bids, blabels), pipe_gang.BERT_STEPS,
        os.path.join(out, "bert_ref.pt"))
    add(_counts(fa, k2))
    # a gradient off by a factor of 2 moves the parameters about half
    # their whole movement away from the reference
    sens = min(moved, bert_moved) / 2 / PIPE_PARAM_ATOL
    print(f"8f references on {card}: SGD lr {pipe_gang.SGD_LR}, the clip "
          f"at {pipe_gang.SGD_CLIP:g} never engaged; gpt2_small one process,"
          f" fp32 losses {ref_losses}, global norms {ref_norms}, largest "
          f"parameter move {moved:.4g}; bert-base Pipe one process (32 x "
          f"512), fp32 losses {bert_losses}, global norms {bert_norms}, "
          f"largest move {bert_moved:.4g}; a gradient off by a factor of 2 "
          f"would put a parameter about {sens:.3g}x PIPE_PARAM_ATOL off",
          flush=True)
    check(sens >= 10, f"8f: PIPE_PARAM_ATOL {PIPE_PARAM_ATOL} cannot see a "
          f"gradient off by a factor of 2 ({sens:.3g}x)")
    del bert
    gloo_release()
    fleet.fleet_state().__init__()
    env.set_mesh(None)
    gc.collect()
    torch.cuda.empty_cache()

    # (b)-(f): gloo gangs on this card
    results = {}
    for nproc, cases in PIPE_GANGS:
        t0 = time.perf_counter()
        _run_gang("pipe_gang.py", nproc, out, cases, "8f")
        print(f"8f: the {nproc}-rank gang {cases}: "
              f"{time.perf_counter() - t0:.1f} s wall", flush=True)
        for name in cases:
            results[name] = [json.load(open(os.path.join(
                out, f"{name}.rank{r}.json"))) for r in range(nproc)]
    attn = results.pop("attn")[0]
    attn.pop("wall_s")
    for name, errs in attn.items():
        print(f"8f attention: {name} (sep 2, (2, 1024, 12, 64) bf16, "
              f"causal) against one rank's flash attention, max |diff| / "
              f"max |ref| of out, dq, dk, dv: "
              f"{[float(f'{e:.3g}') for e in errs]} (limit "
              f"{PIPE_ATTN_RTOL})", flush=True)
        check(max(errs) <= PIPE_ATTN_RTOL,
              f"8f attention: {name} off the flash attention by {errs}")
    mem = results.pop("mem")
    for r, m in enumerate(mem):
        ratio = m["M8"] / m["M4"]
        print(f"8f memory: pp rank {r} peak over one fp32 1F1B step, "
              f"microbatches of 2 rows: M 4 {m['M4']:.3f} GiB, M 8 "
              f"{m['M8']:.3f} GiB, ratio {ratio:.4f} (limit "
              f"{PIPE_MEM_RATIO})", flush=True)
        check(ratio <= PIPE_MEM_RATIO, f"8f memory: pp rank {r}'s peak "
              f"grows {ratio:.3f}x from M 4 to M 8")
    for name, ranks in results.items():
        r0 = ranks[0]
        n_steps = pipe_gang.BERT_STEPS if name == "f" else steps
        Lc = 12
        for r, res in enumerate(ranks):
            w = _pipe_want(name, r, len(ranks), Lc, r0["M"], r0["V"],
                           n_steps, True)
            wb = _pipe_want(name, r, len(ranks), Lc, r0["M"], r0["V"],
                            pipe_gang.TIMED, False)
            check(res["fp32_launches"] == w and res["bf16_launches"] == wb,
                  f"8f ({name}) rank {r}: launches {res['fp32_launches']} "
                  f"(fp32), {res['bf16_launches']} (bf16) != {w}, {wb}")
            check(res["losses"] == r0["losses"]
                  and res["norms"] == r0["norms"],
                  f"8f ({name}): rank {r}'s losses or norms differ from "
                  f"rank 0's")
            add(res["fp32_launches"])
            add(res["bf16_launches"])
        print(f"8f ({name}) mesh {r0['mesh']} M {r0['M']} V {r0['V']}, "
              f"{len(ranks)} ranks on {card}, fp32: losses {r0['losses']}; "
              f"distance from one process: loss {r0['loss_rel']:.3g} "
              f"(limit {PIPE_LOSS_RTOL}), global norm {r0['norm_rel']:.3g} "
              f"(limit {PIPE_NORM_RTOL}), parameters {r0['param_abs']:.3g} "
              f"(limit {PIPE_PARAM_ATOL}); bf16 AMP step "
              f"{float(np.median(r0['bf16_step_ms'])):.1f} ms p50 of "
              f"{[round(x, 1) for x in r0['bf16_step_ms']]} (gloo through "
              f"the host, not a measure of NCCL), peak "
              f"{max(x['peak_gib'] for x in ranks):.2f} GiB a rank; "
              f"launches a rank fp32 {[x['fp32_launches'] for x in ranks]}"
              f"; {r0['wall_s']:.1f} s wall", flush=True)
        check(r0["loss_rel"] <= PIPE_LOSS_RTOL
              and r0["norm_rel"] <= PIPE_NORM_RTOL
              and r0["param_abs"] <= PIPE_PARAM_ATOL,
              f"8f ({name}): fp32 distance from one process {r0['loss_rel']}"
              f", {r0['norm_rel']}, {r0['param_abs']} over the limits")
    return total


def _profile_step(torch, run, step_ms):
    """Device time of one more training step (``run()``) by kernel, from
    ``torch.profiler`` (CUPTI): the largest kernels, and the device's
    busy share of the timed step p50."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # device-side events only: an operator's own entry repeats the device
    # time of the kernels it launched
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    print(f"profiled step: device busy {busy:.2f} ms = "
          f"{busy / step_ms:.3f} of the step p50 {step_ms:.2f} ms; by "
          "kernel (ms, launches):", flush=True)
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:15]:
        print(f"  {ms:9.3f} {n:6d}  {name[:90]}", flush=True)


_FA = "paddle_tpu/ops/pallas/flash_attention.py"
KERNELS = {
    "K1": ("flash_fwd", "paddle_tpu_torch/csrc/flash_fwd.cu",
           f"{_FA}:54, {_FA}:108"),
    "K2": ("layer_norm", "paddle_tpu_torch/csrc/layer_norm.cu",
           "paddle_tpu/ops/pallas/layer_norm.py:31"),
    "K3a": ("flash_bwd_fused", "paddle_tpu_torch/csrc/flash_bwd.cu",
            f"{_FA}:362"),
    "K3b-dkv": ("flash_bwd_dkv", "paddle_tpu_torch/csrc/flash_bwd.cu",
                f"{_FA}:162"),
    "K3b-dq": ("flash_bwd_dq", "paddle_tpu_torch/csrc/flash_bwd.cu",
               f"{_FA}:215"),
    "K4": ("paged_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
           "paddle_tpu/ops/pallas/paged_attention.py:103"),
    "K5": ("chunk_prefill", "paddle_tpu_torch/csrc/chunk_prefill.cu",
           "paddle_tpu/ops/pallas/chunk_prefill.py:93"),
    "K4-int8": ("paged_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:134"),
    "K5-int8": ("chunk_prefill", "paddle_tpu_torch/csrc/chunk_prefill.cu",
                "paddle_tpu/ops/pallas/chunk_prefill.py:126"),
    "K5-bf16": ("chunk_prefill (bf16 mma.sync body)",
                "paddle_tpu_torch/csrc/chunk_prefill.cu",
                "paddle_tpu/ops/pallas/chunk_prefill.py:93"),
    "K5-int8-bf16": ("chunk_prefill (bf16 mma.sync body, int8 pools)",
                     "paddle_tpu_torch/csrc/chunk_prefill.cu",
                     "paddle_tpu/ops/pallas/chunk_prefill.py:126"),
    "K4-bf16": ("paged_attention (bf16 mma.sync cluster body)",
                "paddle_tpu_torch/csrc/paged_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:103"),
    "K4-int8-bf16": ("paged_attention (bf16 mma.sync cluster body, int8 "
                     "pools)", "paddle_tpu_torch/csrc/paged_attention.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:134"),
    "K4-bf16-s17": ("paged_attention (bf16 mma.sync cluster body, a verify "
                    "of 17 rows: two row tiles)",
                    "paddle_tpu_torch/csrc/paged_attention.cu",
                    "paddle_tpu/ops/pallas/paged_attention.py:103"),
    "K2-fp16": ("layer_norm (fp16)", "paddle_tpu_torch/csrc/layer_norm.cu",
                "paddle_tpu/ops/pallas/layer_norm.py:31"),
    "K4-fp16": ("paged_attention (fp16 mma.sync cluster body)",
                "paddle_tpu_torch/csrc/paged_attention.cu",
                "paddle_tpu/ops/pallas/paged_attention.py:103"),
    "K4-int8-fp16": ("paged_attention (fp16 mma.sync cluster body, int8 "
                     "pools)", "paddle_tpu_torch/csrc/paged_attention.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:134"),
    "K5-fp16": ("chunk_prefill (fp16 mma.sync body)",
                "paddle_tpu_torch/csrc/chunk_prefill.cu",
                "paddle_tpu/ops/pallas/chunk_prefill.py:93"),
    "K5-int8-fp16": ("chunk_prefill (fp16 mma.sync body, int8 pools)",
                     "paddle_tpu_torch/csrc/chunk_prefill.cu",
                     "paddle_tpu/ops/pallas/chunk_prefill.py:126"),
    "K1-fp16": ("flash_fwd (fp16 mma.sync body)",
                "paddle_tpu_torch/csrc/flash_fwd.cu",
                f"{_FA}:54, {_FA}:108"),
    "K3a-fp16": ("flash_bwd_fused (fp16 mma.sync body)",
                 "paddle_tpu_torch/csrc/flash_bwd.cu", f"{_FA}:362"),
}
# the row each kernel reports in the kernels line: for K2, K4 and K5
# fp32 (the serving phase's dtype) at the decode shape for K2 and K4,
# and the deepest prefix for K5; for K4's and K5's bf16 bodies (phase
# 5c's) bf16 at the decode shape and the deepest prefix, and K4's at
# phase 5d's verify of 16 drafts (s 17); their fp16 instantiations and
# K2's (phase 5h's) at the same shapes in fp16; for the flash
# kernels bf16 (the training phase's dtype under AMP) at the shape of the
# path that launches them, and their fp16 bodies (phase 6b's) at the
# training shape.
# id -> (row's kernel, dtype, shape)
_K5_DEEP = [128, 517, 12, 64, 16, 64]
HEADLINE = {"K1": ("K1", "bfloat16", list(FLASH_CASES[0])),
            "K2": ("K2", "float32", [8, 768]),
            "K3a": ("K3a", "bfloat16", list(FLASH_CASES[0])),
            "K3b-dkv": ("K3b-dkv", "bfloat16", list(FLASH_LONG)),
            "K3b-dq": ("K3b-dq", "bfloat16", list(FLASH_LONG)),
            "K4": ("K4", "float32", [8, 1, 12, 64, 16, 64]),
            "K5": ("K5", "float32", _K5_DEEP),
            "K4-int8": ("K4-int8", "float32", [8, 1, 12, 64, 16, 64]),
            "K5-int8": ("K5-int8", "float32", _K5_DEEP),
            "K5-bf16": ("K5", "bfloat16", _K5_DEEP),
            "K5-int8-bf16": ("K5-int8", "bfloat16", _K5_DEEP),
            "K4-bf16": ("K4", "bfloat16", [8, 1, 12, 64, 16, 64]),
            "K4-int8-bf16": ("K4-int8", "bfloat16", [8, 1, 12, 64, 16, 64]),
            "K4-bf16-s17": ("K4", "bfloat16", [8, 17, 12, 64, 16, 64]),
            "K2-fp16": ("K2", "float16", [8, 768]),
            "K4-fp16": ("K4", "float16", [8, 1, 12, 64, 16, 64]),
            "K4-int8-fp16": ("K4-int8", "float16", [8, 1, 12, 64, 16, 64]),
            "K5-fp16": ("K5", "float16", _K5_DEEP),
            "K5-int8-fp16": ("K5-int8", "float16", _K5_DEEP),
            "K1-fp16": ("K1", "float16", list(FLASH_CASES[0])),
            "K3a-fp16": ("K3a", "float16", list(FLASH_CASES[0]))}


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs the "
             "port on an NVIDIA card")
    # fp32 products in full fp32 everywhere: the fp32 comparisons hold
    # two fp32 computations of the same function to each other
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_phase(torch)
    mark = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        print(f"phase {phase}: {now - mark[0]:.1f} s wall", flush=True)
        mark[0] = now

    build_phase()
    ptxas_phase()
    lap("build + ptxas")
    timer = Timer(torch)
    rows = []
    print("kernels vs plain versions (device ms, cold L2):", flush=True)
    layer_norm_phase(torch, timer, rows)
    decode_phase(torch, timer, rows, int8=False)
    chunk_phase(torch, timer, rows, int8=False)
    decode_phase(torch, timer, rows, int8=True)
    chunk_phase(torch, timer, rows, int8=True)
    lap("K2, K4, K5")
    long_launches = flash_phase(torch, timer, rows)
    lap("flash")
    launches, model, fp_agg, fp_reqs = serving_phase(torch, card)
    fp_launches = dict(launches)
    lap("serving")
    q_launches = serving_q_phase(torch, card, model, fp_agg)
    lap("int8 serving")
    launches.update({k: q_launches[k] for k in ("K4-int8", "K5-int8")})
    bf16_launches, bf16_q_launches, bf16_model, bf16_aggs, bf16_reqs = \
        serving_bf16_phase(torch, card)
    lap("bf16 serving")
    k16_launches, spec_reqs = serving_spec_phase(
        torch, card, model, bf16_model, fp_agg, bf16_aggs, rows)
    lap("spec serving")
    serving_resilience_phase(torch, card, model, bf16_model, fp_launches,
                             fp_reqs, bf16_launches, bf16_reqs)
    del bf16_reqs
    lap("serving resilience and telemetry")
    del bf16_model
    serving_dense_phase(torch, card, model, fp_agg)
    lap("dense serving")
    fp16_serve, fp16_q_serve = serving_fp16_phase(torch, card)
    lap("fp16 serving")
    tier_reqs = serving_tier_phase(torch, card, model)
    lap("host tier")
    generate_phase(torch, card, model)
    lap("generate")
    draft_phase(torch, card, model)
    lap("draft-model spec serving")
    frontdoor_fleet_phase(torch, card, model, fp_reqs)
    lap("front door and fleet")
    lora_constrained_phase(torch, card, model, fp_reqs, fp_agg)
    lap("adapters, grammars, score and embed")
    adaptive_launches = adaptive_phase(torch, card, model, fp_reqs, fp_agg,
                                       fp_launches, spec_reqs, tier_reqs)
    lap("adaptive serving")
    for k in ("K2", "K4", "K5"):
        launches[k] += adaptive_launches[k]
    small_launches = small_heads_phase(torch, card)
    lap("small head dims on the paged engine")
    for k in ("K2", "K4", "K5", "K4-int8", "K5-int8"):
        launches[k] += small_launches[k]
    del model, spec_reqs, tier_reqs
    launches.update({"K5-bf16": bf16_launches["K5"],
                     "K5-int8-bf16": bf16_q_launches["K5-int8"],
                     "K4-bf16": bf16_launches["K4"],
                     "K4-int8-bf16": bf16_q_launches["K4-int8"],
                     "K4-bf16-s17": k16_launches,
                     "K2-fp16": fp16_serve["K2"],
                     "K4-fp16": fp16_serve["K4"],
                     "K4-int8-fp16": fp16_q_serve["K4-int8"],
                     "K5-fp16": fp16_serve["K5"],
                     "K5-int8-fp16": fp16_q_serve["K5-int8"]})
    train_launches, train_perf = training_phase(torch, card)
    lap("training")
    fp16_launches = training_fp16_phase(torch, card, train_perf)
    lap("fp16 training")
    training_defaults_phase(torch, card)
    lap("training at the model's defaults")
    training_resilience_phase(torch, card, train_perf)
    lap("fault-tolerant training")
    offload_launches = offload_phase(torch, card, train_perf)
    lap("ZeRO offload")
    opt_launches = optimizers_phase(torch, card)
    lap("optimizers, fleet and ASP")
    enc_launches = encoder_phase(torch, card)
    lap("encoders (BERT, ERNIE, nn.Transformer)")
    gpt3_launches = gpt3_training_phase(torch, card)
    lap("GPT-3 XL training")
    n5_launches, n5_q_launches = gpt3_serving_phase(torch, card)
    lap("GPT-3 serving in bf16")
    moe_train = moe_training_phase(torch, card)
    lap("GPT-MoE training (8a)")
    moe_serve, moe_serve_q, moe_serve_fp32 = moe_serving_phase(torch, card)
    lap("gpt_moe_1p3b served in bf16 (8b)")
    moe_tiny = moe_tiny_phase(torch, card)
    lap("gpt_moe_tiny on the card against the CPU (8c)")
    fused = fused_phase(torch, card)
    lap("the fused encoder layers (8d)")
    mesh = mesh_phase(torch, card)
    lap("gpt2_small over a mesh of ranks (8e)")
    pipe = pipe_phase(torch, card)
    lap("the pipeline and the sequence axis over ranks (8f)")
    for k in ("K1", "K3a", "K2"):
        mesh[k] += pipe[k]
    launches["K2"] += (enc_launches["K2"] + offload_launches["K2"]
                       + opt_launches["K2"] + gpt3_launches["K2"]
                       + n5_launches["K2"] + n5_q_launches["K2"]
                       + moe_train["K2"] + moe_serve["K2"]
                       + moe_serve_q["K2"] + moe_serve_fp32["K2"]
                       + moe_tiny["K2"] + fused["K2"] + mesh["K2"])
    for k, n in (("K4-bf16", n5_launches["K4"] + moe_serve["K4"]),
                 ("K5-bf16", n5_launches["K5"] + moe_serve["K5"]),
                 ("K4-int8-bf16", n5_q_launches["K4-int8"]
                  + moe_serve_q["K4-int8"]),
                 ("K5-int8-bf16", n5_q_launches["K5-int8"]
                  + moe_serve_q["K5-int8"]),
                 ("K4", moe_tiny["K4"] + moe_serve_fp32["K4"]),
                 ("K5", moe_tiny["K5"] + moe_serve_fp32["K5"])):
        launches[k] += n
    launches.update({"K1": train_launches["K1"] + enc_launches["K1"]
                     + offload_launches["K1"] + opt_launches["K1"]
                     + gpt3_launches["K1"] + moe_train["K1"]
                     + moe_tiny["K1"] + fused["K1"] + mesh["K1"],
                     "K3a": train_launches["K3a"] + enc_launches["K3a"]
                     + offload_launches["K3a"] + opt_launches["K3a"]
                     + gpt3_launches["K3a"] + moe_train["K3a"]
                     + moe_tiny["K3a"] + fused["K3a"] + mesh["K3a"],
                     "K3b-dkv": long_launches["bwd_dkv"],
                     "K3b-dq": long_launches["bwd_dq"],
                     "K1-fp16": fp16_launches["K1"],
                     "K3a-fp16": fp16_launches["K3a"]})

    out = []
    for kid, (name, src, replaces) in KERNELS.items():
        row = next(r for r in rows if [r["kernel"], r["dtype"], r["shape"]]
                   == list(HEADLINE[kid]))
        check(launches[kid] > 0, f"{kid} was never launched on the path")
        out.append({"name": f"{kid} {name}", "route": "cuda",
                    "source": src, "replaces": replaces,
                    "launches": launches[kid],
                    "max_abs_err": row["max_abs_err"],
                    "ms": row["kernel_ms"],
                    "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"]})
    print(f"total {time.perf_counter() - t_start:.1f} s on {card}",
          flush=True)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
