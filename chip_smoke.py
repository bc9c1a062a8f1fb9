#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on a GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without a card, and prints
no result then. Imports nothing of JAX or of the JAX package. Phases, each
printed with its seconds:

1. device  -- ``nvidia-smi`` name and power limit, torch's device name/count.
2. build   -- compiles ``src/repro_torch/kernels/csrc/*.cu`` (first use);
   logs ptxas' registers and spills of the flash kernels at head_dim 128
   and 256 (bf16: the wgmma forward and the tensor-core backward; float32:
   the CUDA-core kernels), of block_topk and of the ssd kernels at hd 64,
   the flash kernels' dynamic shared memory at 128 and 256 (the wrapper's
   tile plan) and the ssd plan (head groups, shared memory, grids) at the
   three ssd shapes below.
3. kernels -- every kernel of the main path against its plain PyTorch
   version on the card, at the main path's shapes (rcv1 preset: N=10,
   D=47,236, k=74 for a step; D=47,239, k=7,400 for init_state's phibar
   scatter) and at ragged small shapes, float64 and float32, with
   padded entries and (for sparse_axpy) duplicate indices. float64
   sparse_axpy must be bit-exact, sparse_dot within 1e-12 (float32: 1e-5).
   Times per call from CUDA events after warm-up, beside the plain
   version's time and the least time the card could take (bound);
   sparse_dot in turns with the CSR call, and both calls' host
   microseconds (time.perf_counter over 10,000 calls, no synchronisation).
   block_topk against its plain version, bit for bit (values as bits) and
   by the registry's comparator, one launch a call, at (nb, block, k) =
   (288000, 4096, 40) (the gossip step's embedding leaf: 2 pods x 144,000
   blocks), (7, 2304, 23), (5, 64, 1), (3, 16, 16), (4, 4096, 4096),
   (3, 8193, 81), (2, 8192, 8192), (3, 65536, 655) and (2, 1000003, 10000)
   (the last two streamed), on random rows, rows with many ties, constant
   rows and rows with NaNs of several payloads and signs, +-inf and +-0;
   timed at the first and the last beside the bound, the plain version
   and torch.topk + gather, and at the first under other plans (a warp a
   row, 1-3 stages, 256 candidates). ``chip_smoke.py --topk-profile`` runs
   the block_topk and sparse work of this phase alone (a fresh process).
4. slice   -- the main path: ``solve()`` on the paper's Section-7 setup
   (rcv1 preset, N=10, q=100, Erdos-Renyi(0.4) seed 0, Laplacian W,
   lam = 1/(10 Q)) for dsba and dsa on ridge, logistic and AUC:
   dense for 100 steps on the card, held to the same port run on the CPU
   with the plain kernels (<= 1e-10: cuBLAS sums the 10x10 mixing product
   in another order than the CPU); sparse relay (verify=True) for 100
   steps on the card, held to the dense run (<= 1e-12) and to the
   closed-form steady-state doubles per iteration. The kernel launch
   counts of every run are set to 0 before it and must equal what the
   code predicts after it.
5. profile -- wall and device-busy time per step, the device's idle share
   and the kernels with the most device time (torch.profiler), for dense
   dsba on ridge and logistic and for the ridge relay.
6. widest  -- logistic_news20 (d=1,355,191, k=450) dense dsba, 20 steps.
7. serve   -- minitron-8b at full width (random bf16 weights from a seeded
   torch.Generator on the card) behind ``serve.Scheduler``:
   PoolConfig(max_batch=8, block_size=16, max_len=1024, prompt_pad=256,
   n_blocks=513), 12 requests with prompts of 16-256 tokens and 16-64 new
   tokens (numpy seed 0). Checks: every request finishes with its token
   count; decode_attention launches = decode steps x 32 layers; the pool
   is never reallocated (data_ptr); in the first 4 decode steps every
   layer's decode_attention call is held to the plain version on its own
   inputs (``ops.held_to_plain``, bf16 bar). Reports decode ms per step,
   tokens/s, wall vs device-busy time of a replayed decode step, its idle
   share and its weight-read bound, and (not gated, see 10) the on vs off
   and paged vs contiguous logit differences.
8. attention -- flash_attention and decode_attention against their plain
   versions on the card, bf16 and f32, within the registry bars (2e-2,
   2e-5): flash at S=2048 with minitron-8b's heads (32 q, 8 kv, D=128),
   a ragged S, causal and not, window, softcap, lse included; decode at
   the serve phase's shape (a snapshot of its table and lengths over the
   pool of layer 0, in bf16: its K/V reach ~100, far from the unit scale
   the f32 bar is set for), lengths 0, 1, a partial page and a full table, null
   pages past each length, GQA group 4 and MQA, window and softcap at
   small sizes; at long contexts (minitron-8b's heads, every length
   32,768) the whole batch at B = 8 and 8 of the 128 sequences at the
   reference's decode_32k; two calls bit-equal (the split merge is
   deterministic), with no host sync in a call. Then, in a fresh process
   (``chip_smoke.py --decode-profile LENGTHS``), decode is timed at a
   snapshot of the serve shape (the busiest step's lengths) and at both
   long shapes by CUDA events and by profiler device time, beside the
   bound, the plain version, SDPA over the gathered pages (which only the
   timing table uses) and the plan's splits. gemma2-2b's attention is held
   too (8/4 heads, D=256, causal, window 4096, softcap 50, at S=2048 and at
   S=4608, where the window bites), forward and backward, bf16 and f32.
   Then, in a fresh process (``chip_smoke.py --attention-profile``; late
   in this one torch.profiler has dropped kernel events), the bf16 flash
   forward and backward are timed at D=128 (the score and train shapes)
   and at D=256 (the gossip shape, S=2048): CUDA events, profiler device
   time under the kernels' names (``flash_fwd_wgmma_kernel``; backward
   ``flash_bwd_{dq,dkv}_wgmma_kernel`` at D=128, ``..._mma_kernel`` at
   D=256), the plain
   version, the bound and, at D=128, SDPA forward and backward (at D=256
   SDPA without the softcap is logged only: not the same function).
9. score   -- ``transformer.forward`` at full width, B=1, S=2048: 32
   flash_attention launches, each held to the plain version on its own
   inputs; finite logits of the expected shape.
10. conditioned -- the same weights with the attention projections
   rescaled to 1/sqrt(contracted width) (``condition_attention`` says why:
   with the reference's init the whole-model logits are a chaotic function
   of the attention outputs). Gated end to end: the first 4 serve decode
   steps, decode_kernel "on" vs "off" logits within the bf16 bar on the
   same pool state; request 0's first decode-step logits, paged vs the
   contiguous ``generate``, within the bf16 bar times the layer count
   (the reference's own paged-vs-contiguous rule, tests/test_serve.py);
   forward at S=2048, attention_kernel "on" vs "off" within the bf16 bar.
11. train -- the serve weights are freed; minitron-8b at full width
   (d 4096, 32/8 heads, head_dim 128, d_ff 16384, vocab 256,000) cut to 4
   layers (its float32 train state at 32 layers, 158 GB, fits no card)
   trains 5 steps at B=2, S=2048 through ``batch_at``,
   ``TrainConfig``/``AdamConfig`` and ``train_step``, wired as
   ``launch/train.py`` wires them (remat "full"). Step 0 holds every
   flash_attention forward and flash_attention_bwd call to its plain
   version on its own inputs (bf16 bars 2e-2 and 5e-2; the backward's
   gradients are small, a mean loss over 4,096 tokens, so each of dq, dk,
   dv is also held to 5e-2 in relative norm, and their size is logged);
   steps 1-4 report
   wall time, device-busy time (profiler, step 4), idle share, launches
   per step by kernel (2 forward launches a layer: forward and recompute;
   2 backward launches a layer: dq and dk/dv) and peak memory. Then, on the
   same parameters rescaled by ``condition_attention``, one ``local_grads``
   with attention_kernel "on" against "off": loss within 1e-3 relative,
   every gradient leaf within the bf16 gradient bar (5e-2) in relative
   Frobenius norm, reported layer by layer.
12. gossip -- in the ``--gossip-ranks`` process (phase 28), as the reference
   of the rank run: gemma2-2b at full width (d 2304,
   8/4 heads, head_dim 256, d_ff 9216, vocab 256,000, tied embedding,
   softcaps 50/30, window 4096 on the local layer) cut 26 -> 2 layers (the
   gossip state is 8 float32 copies a pod: 2 pods x 8 x 2.98 GB = 47.7 GB
   at 2 layers, 167 GB at 26) trains 6 DSBA steps (``core/gossip.py``,
   ``mode="dsba"``, ``compression="block_topk"``, ring of 2 pods, B=1 and
   S=2048 a pod from ``batch_at``, lr 1e-3 constant, bf16 compute, remat
   "full"). Step 0 holds every block_topk call bit for bit and every flash
   forward and backward call within its bar to the plain version; steps
   1-4 are timed (wall, peak memory), step 5 profiled (device busy, idle
   share, top kernels, the update half's elementwise share). Every step:
   launches (11 block_topk, 8 flash forward, 8 flash backward), finite
   loss, grad norm and consensus distance, wire bytes per pod equal to the
   closed form sum of nb * k_b * 8 (58.2 MB against 2.98 GB dense).
   ``chip_smoke.py --gossip-profile`` runs this phase alone and then
   block_topk on the embedding leaf's rows of the next exchange: bit for
   bit, its time, and the shares of rows split in one pass and of rows
   whose boundary bin overflows the candidate lists. In phase 28 the same
   setup's first 2 steps with compression "none" follow (their consensus
   distance reported, not gated; their params' digests kept).
13. launcher -- ``python -m repro_torch.launch.train --reduced`` on the
   card in a subprocess: 6 steps with --ckpt-every 3; the final checkpoint
   is dropped (a crash after step 3's) and a second run resumes from it; its
   final train state must be bit-equal to the uninterrupted run's. It
   runs side by side with 14 (two resume checks that time nothing).
14. gossip example -- ``python -m repro_torch.examples.train_lm_gossip``
   (tiny, 4 pods, topk, a pod killed at step 5, 12 steps, checkpoints every
   4) on the card: the pods shrink to 3, the loss is finite, and a run
   resumed from step 8's checkpoint ends bit-equal.
15. ssd -- ssd_chunk forward and backward against their plain versions in
   float64 on the same float32 inputs (registry bars 2e-5; 2e-4 elementwise
   and in relative norm), at the score (1, 8, 256, 64, 64, 128), train
   (4, 8, ...) and prefill (1, 1, ...) shapes (B, nc, Q, nh, hd, ds), ragged
   Q (1, 5, 37) and nh (3, 6), and fast decay (a_log in [-8, -6]: every
   output and gradient finite); relative Frobenius errors logged; at unit
   scale the kernel's and the float32 plain version's misses are reported.
16. ssm serve -- mamba2-1.3b at full width and depth (48 layers, d 2048,
   d_inner 4096, 64 heads of 64, state 128, vocab 50,280; random bf16
   weights from seed 0) behind ``serve.Scheduler`` with the serve phase's
   pool and 12 requests. Checks: token counts; no page ever allocated; the
   state pool never reallocated; ssd_chunk launches = prefills x 48 and none
   in decode; every ssd call of the first step's prefills held to the plain
   version; a padded prefill's state equals a prefill of exactly valid_len
   tokens (float32 compute, every layer, the f32 bar); request 0's first
   decode-step logits paged vs the contiguous ``generate`` within the bf16
   bar in relative norm. Reports decode ms, tokens/s, a replayed decode
   step's wall vs device busy, idle share and launches.
17. ssm score -- ``forward`` at B=1, S=2048: 48 ssd_chunk launches, each
   held to the plain version; finite logits; ssm_kernel "on" vs "off"
   within 2e-2 in relative norm.
18. ssm train -- mamba2-1.3b at full width and depth, B=4, S=2048 from
   ``batch_at``, AdamW at the launcher's defaults, remat "full", 5 steps:
   step 0 holds every ssd forward (96) and backward (48) call to the plain
   version; steps 1-4 timed, peak memory; launches asserted every step (96
   forward, 3 x 48 backward); one ``local_grads`` "on" vs "off" (loss within
   1e-3 relative, every gradient leaf within 5e-2 in relative norm). Then,
   in a fresh process (``chip_smoke.py --ssm-profile``; late in this one
   torch.profiler has dropped kernel events), the SSD kernels are timed at
   the train, score and prefill shapes (events and profiler, beside both
   bounds and the plain version) and a train step is profiled (device
   busy, idle share).
19. hybrid -- in a fresh process (``chip_smoke.py --hybrid``; it runs alone
   too): zamba2-1.2b at full width and depth (38 Mamba2 layers, d 2048, 64
   heads of 64, state 64; one shared attention block, MHA 32/32 of head_dim
   64, d_ff 8192, after every 6th layer; vocab 32,000; random bf16 weights
   from seed 0). First the kernels at its new shapes: the flash forward at
   B=1, S=2048 and the backward at B=4, S=2048 (D=64, 32/32, causal; SDPA
   beside them computes the same function), the SSD pair at state 64 at
   the train, score and prefill shapes. Serve: the serve phase's pool and
   12 requests; token counts, decode_attention launches = decode steps x 6,
   ssd_chunk = prefills x 38, no flash launch, the pools never
   reallocated, every decode_attention call (D=64, group 1) of the first 4
   decode steps and every ssd call of the first step's prefills held to the
   plain version; decode timed at the busiest step's snapshot; a replayed
   decode step's wall, device busy and idle share. Score: ``forward`` at
   B=1, S=2048, 6 flash and 38 ssd launches, each held. long_500k (the
   reference's decode from a 524,288-token cache, batch 1): a pool of
   random K/V (25.8 GB), ssm state and a permuted page table from a seeded
   generator, not prefilled; a unit-normal query over all of the first
   use's pages held to the bf16 bar and DECODE_LONG_REL, with the
   skipped-tile and dropped-split controls, and timed (splits, bound,
   SDPA); then 3 ``decode_step_paged`` steps ending at the full cache, each
   decode_attention call held the same way; a step's wall and device time
   against its read bound. Conditioned (the shared attention rescaled as
   ``condition_attention`` does): forward "on" vs "off" and request 0's
   first decode step paged vs ``generate``, within the bf16 bar in
   relative norm. Train: 5 steps at B=4, S=2048, remat "full", AdamW at
   the launcher's defaults; step 0 holds every flash forward (12) and
   backward (6) and every ssd forward (76) and backward (38) call;
   launches asserted every step; steps 1-3 timed, step 4 profiled; peak
   memory. Its launches join the kernels line.
20. moe -- in a fresh process (``chip_smoke.py --moe``; it runs alone too):
   qwen2-moe-a2.7b at full width (24 layers, d 2048, MHA 16/16 of head_dim
   128 with qkv biases, 60 experts top-4 of d_ff 1408, a shared expert of
   5632, capacity factor 1.25, vocab 151,936; random bf16 weights from seed
   0, 29.25 GB). First the flash kernels at its shapes (D=128, 16/16,
   causal: forward B=1, S=2048, backward B=2, S=2048, beside SDPA). Serve:
   the serve phase's pool and 12 requests at all 24 layers; token counts,
   decode_attention launches = decode steps x 24, no flash launch, the pool
   never reallocated, every decode_attention call (D=128, group 1) of the
   first 4 decode steps held; decode timed at the busiest step's snapshot;
   the routes' dropped pairs reported (at decode the capacity is 1 a
   expert: C = int(8 x 4 / 60 x 1.25) = 0, floored at 1). Score: ``forward``
   at B=1, S=2048, 24 flash launches, each held; the on vs off logits and
   route flips reported. Train: full width cut to 4 layers (float32 params,
   grads and AdamW moments at 16 B a parameter: 46 GB; 229 GB at 24), B=2,
   S=2048, 5 steps, remat "full"; step 0 holds every flash forward (8) and
   backward (4) call; launches asserted every step; peak memory.
21. encdec -- in a fresh process (``chip_smoke.py --encdec``; it runs alone
   too): whisper-small at full width and depth (12 + 12 layers, d 768, MHA
   12/12 of head_dim 64, d_ff 3072, 1,500 frames, vocab 51,865). First the
   flash kernels at its shapes: the encoder's non-causal S = Sk = 1,500
   (1,500 = 23 x 64 + 28: the kernel masks the keys past Sk and the
   backward the query rows past S) forward at B=1 and B=8 and backward at
   B=8, the decoder's causal S=448 forward and backward at B=8, beside SDPA
   (the bound counts S x Sk pairs non-causal). Serve: 12 requests, each
   with seeded (1500, 768) frames; the encoder runs at admission (12
   non-causal flash launches a request, those of the first step's 8
   admissions held), decode_attention = decode steps x 12, each call of the
   first 4 decode steps held. Score: ``forward`` at B=8, decoder S=448 over
   1,500 frames, 24 flash launches, each held. Conditioned (every attention
   rescaled as ``condition_attention`` does): forward "on" vs "off" and
   request 0's first decode step paged vs ``generate``, within the bf16
   bar in relative norm. One ``local_grads`` at the reference's init,
   every flash backward call against its plain version, reported (its
   near-argmax attention grows the cotangents to ~1e15: single elements
   fall outside the elementwise bar in the kernel and the plain version
   alike). Train: full depth from a conditioned train state, B=8, S=448, 5
   steps; step 0 holds every flash forward (48) and backward (24) call.
22. options -- in a fresh process (``chip_smoke.py --options``; it runs alone
   too): the training options at full width, TF32 off (float32 products
   exact). First the flash kernels at llama3-405b's head layout (128/8
   heads, D=128, causal, B=1, S=4,096), before any model exists (the plain
   backward's S x S scores take ~8.6 GB a call): one forward and backward
   through the registry held to the plain version, then each timed beside
   the plain version, the bound and SDPA. Then llama3-405b (arXiv:2407.21783)
   at full width cut 126 -> 1 layer (7.39e9 parameters: bf16 weights,
   gradients and moments 59.1 GB; with float32 moments 88.7 GB, more than
   the card) trains 3 steps with ``AdamConfig(state_dtype=torch.bfloat16)``
   under remat "dots" and one under "full", B=1, S=4,096 (the reference's
   train_4k; its batch of 256 cut to 1) from ``batch_at``, AdamW at the
   launcher's defaults but warmup 1; each step profiled (wall, device busy,
   idle share), its launches asserted (2 flash forward, 2 backward), its
   peak memory under 80 GB, finite loss and grad norm; step 1's update of
   sampled slices of embed, mlp and a norm scale held to the reference's
   formula recomputed in float64 from the step's own gradients and moments
   (within one bf16 ulp). Then minitron-8b at full width and depth with
   blockwise attention and conditioned attention weights:
   ``serve.generate`` prefills one seeded 32,768-token prompt (the
   reference's prefill_32k) and decodes 4 tokens with no kernel launched;
   the prefill's wall, device time (CUDA events) and peak memory; its
   last-position logits held to the flash stack on the same tokens with no
   cache (32 flash launches at S=32,768, a shape no plain version can hold:
   its scores would take 137 GB) within the bf16 bar; at S=4,096 a
   blockwise prefill held to the plain cached path the same way. Its
   launches join the kernels line.
23. solvers -- in a fresh process (``chip_smoke.py --solvers``; it runs
   alone too): the registry's other methods (extra, dlm, ssda, mudag,
   sliding, dsgda, personal) through ``solve()`` at the paper's rcv1
   Section-7 setup, every (method, family) pair the registry supports
   (personal with a per-node lam of 1x-2x 1/(10Q); SSDA cut to d=4,096 for
   ridge and 1,024 for logistic: its grad f* holds a d x d factor a node),
   10 steps on the card (SSDA 4, at eta = lam) held to the same run on the
   CPU (<= 1e-10, DOUBLEs equal), no registry kernel launched. Each method with a step of its own
   profiled (wall, device busy, idle share, launches a step, top
   kernels). Then benchmarks/bench_table1.py's setup (N=6, q=30, d=200,
   k=8, ER(0.4)): every method's iterations to dist2 <= 1e-10 on the card
   equal the reference's counts (``TABLE1_COUNTS``; the CPU's are held to
   them by tests/test_torch_table1.py); each run stops one record period
   past the count; dsba/dsa launch as predicted.
24. faults -- in a fresh process (``chip_smoke.py --faults``; it runs alone
   too): dynamic networks, fault injection and checkpoint/resume through
   ``solve()`` at the rcv1 Section-7 setup (ridge; dsgda on AUC), each
   held to the same solve() on the CPU (z and dist2 <= 1e-10; DOUBLEs,
   ints and the faults/schedule/churn_rows records equal; some CPU sides
   cut, ``FAULTS_CPU_STEPS``) with dsba/dsa launching as predicted: a p = 0
   plan bit-equal to the plan-free run (dense and relay); link faults
   (dsba, dsa, mudag), stragglers and both composed (dense); link faults
   on the relay; a three-segment schedule (ER seed 0, ring, ER seed 1 at
   0/15/30 of 90) dense and relay; a kill of the degree-6 hub at 15 and
   a join at 30 (dsba dense and relay, mudag, dsgda on AUC); every check's
   length is ``FAULTS_CHECK_STEPS`` (cut to pay for ``--launch``: p = 0
   24 steps, link faults and stragglers 30). Checkpoint/
   resume: dense dsba 100 steps (every 25, stopped at 50) and relay 50
   steps (every 25, stopped at 25), bit-equal to the uninterrupted card
   run, with a save's and a restore's bytes and seconds.
   benchmarks/bench_faults.py's curve: the p = 0 counts equal
   ``FAULTS_COUNTS``, the p > 0 plateaus the CPU's within 1e-10 relative.
   Profiles of the dense step plain, with the link mask and with
   stragglers, and of the relay with and without a sent_mask. Its
   launches join the kernels line.
25. sweep -- in a fresh process (``chip_smoke.py --sweep``; it runs alone
   too): hyperparameter sweeps as one batched computation at the rcv1
   Section-7 setup (ridge). ``solve_many`` over benchmarks/
   bench_convergence.py's 5-alpha dsba grid (0.5-8) and a 3-alpha dsa grid,
   40 steps: bit-equal to one ``solve()`` an alpha on the card, within
   1e-10 of the same sweep on the CPU, launching one run's kernels
   (``expected_launches``) for the whole grid; ``run_sparse_many`` on 3
   alphas bit-equal to ``run_sparse`` (launches: one relay's), its peak
   bytes a run and the batch the card's free memory takes; EXTRA and
   Mudag's K grid {2, 5} within 1e-10 of sequential runs (DOUBLEs equal);
   two batched steps with every sparse_dot and sparse_axpy call held to
   its plain version at B*N = 50 rows (sparse_axpy bit for bit); a second
   alpha on a warm runner adds one hit and no trace. Then the sparse
   kernels timed at 50 rows, the batch's mixing product three ways (B
   products, one broadcast product, one (N, B*D) product: ms and bits),
   the grid's step alone and whole ``solve_many`` calls against one run
   and five (wall, device busy, idle share, launches), cold vs warm
   ``solve()`` (dsba dense and relay, EXTRA), and ``clear_runner_caches()``
   returning the card's allocated bytes to their level before the phase.
   Its launches join the kernels line.
26. launch -- in a fresh process (``chip_smoke.py --launch``; it runs alone
   too): the examples, the registry's public entry points, the dry run and
   the build cache. The examples' ``main()`` on the card with every kernel
   call held to its plain version and their launches counted: quickstart
   (200 steps), decentralized_ridge at rcv1's published width (--dataset
   rcv1 --d 47236, k = 74, 2 passes; SSDA through its q x q Woodbury
   factor), auc_maximization (4 passes), serve_decode for mamba2-1.3b
   (reduced; ssd_chunk in its prefill). The six entry points
   (``flash_attention``, ``decode_attention``, ``saga_sparse_dot``,
   ``saga_sparse_axpy``, ``topk_blocks``, ``ssd_chunk``) with mode "on"
   against "off" at small shapes within the registry's bars, gradients for
   flash (bf16 and f32) and ssd. The dry run of minitron-8b train_4k,
   mamba2-1.3b long_500k, zamba2-1.2b decode_32k, qwen2-moe-a2.7b
   prefill_32k and whisper-small train_4k at full size on the meta device
   with no kernel launched (the wrappers decide by the tensor's device);
   then minitron-8b at 4 layers, train at B=1, S=4,096, counted on meta and
   run on the card: its peak beside ``max_memory_allocated``, its counted
   kernel calls beside the card's launches, its counted FLOPs beside
   ``model_flops``. Two child processes against a private build cache: the
   first builds the sparse kernels' library, the second builds nothing.
   Its launches (the examples' and the fitting cell's) join the kernels
   line.
27. sharded -- in a fresh process (``chip_smoke.py --sharded``; it runs
   alone too): ``solve(comm="sharded")`` with N = 10 ranks (worker
   processes of ``launch.mesh.make_node_mesh``, one gloo group) sharing
   the card at the rcv1 Section-7 setup (ridge): DSBA and DSA 50 steps,
   twice each (the ranks bind their runner in the first), held to the
   dense run on the card (1e-12) and to the CPU (1e-10), DOUBLEs equal;
   a DSBA link-fault run (p = 0.2, 20 steps) held to the dense fault run
   (1e-12, the faults record equal, the counted exchanges the fault-free
   run's). Every rank launches ``expected_launches`` (init included) and
   the parent none. It logs the edge colouring, the collectives record,
   wall and per-rank loop ms a step beside the dense step's, the
   exchange's share of a rank's loop (and the host-staging copies'),
   each rank's peak bytes, the processes on the card and its memory in
   use; closes the mesh and checks that no worker
   outlived it; then asks gloo to send a CUDA tensor on a mesh of 2 ranks
   of its own and logs what happens. The launches, summed over the ranks,
   join the kernels line.
28. gossip ranks -- in a fresh process (``chip_smoke.py --gossip-ranks``;
   it runs alone too): phase 12's 6 steps over 2 ranks of
   ``launch.mesh.make_node_mesh`` sharing the card (one process a pod,
   ``core/gossip.py``'s ``ppermute`` backend: gloo send/recv staged
   through pinned host buffers), then, the ranks closed, phase 12 itself
   (its local 6 steps with every check, and 2 uncompressed steps) as the
   reference (the ranks run first: their two peaks take 75.5 of the card's
   85 GB). Step 0 holds each
   rank's block_topk calls bit for bit and its flash forward and backward
   calls within their bars to the plain versions, and checks (CRC-32) that
   every stream a rank received is the one its peer sent. Every step: 0
   launches in the parent, 11 block_topk, 4 flash forward and 4 flash
   backward a rank; finite loss and grad norm; the bytes each rank sent
   equal to 2 x the closed form (2 x 58.2 MB); after the last step the
   consensus distance (over an ``all_reduce``) and the params of both
   ranks gathered to the host through the mesh's pipes (2 x 2.98 GB, in
   pieces). Then 1 step with compression "none" over the ranks (2 x 2.98
   GB a rank). Against the local runs: every step's loss and grad norm
   within GOSSIP_METRIC_RTOL, the final params bit for bit (the gathered
   ones leaf by leaf; the uncompressed run's by each rank's and each
   local pod's SHA-256 of every leaf, ``pod_digests``). It logs each
   rank's step wall, exchange and staging seconds and peak memory, and
   the card's memory in use. Its launches (the local run's and the
   ranks') join the kernels line.
29. fsdp -- in a fresh process (``chip_smoke.py --fsdp``; it runs alone
   too): the within-pod FSDP x TP train step (``train.sharded``) of
   gemma2-2b at full width cut to 2 layers, B=2, S=2048, 3 steps of the
   default AdamW, on a 2 x 2 ("data", "model") mesh of four ranks sharing
   the card (gloo through pinned host buffers). First, in this process,
   the unsharded ``train_step`` on the same seed and batches (its losses,
   grad norms and the params before and after, one ``.npy`` a leaf on the
   host; the card freed), and as a control the same at 2 microbatches
   (another summation order of the same function). Then the ranks: their
   initial blocks bit-equal to the unsharded init; every step 0 launches
   in the parent, 4 flash forward and 4 flash backward a rank (step 0's
   held to the plain versions), each rank's sent bytes equal to the
   closed form from the pspecs, loss within 1e-3 and grad norm within
   5e-2 of the unsharded step's; after the steps each rank's blocks
   against the same blocks of the unsharded params (read with mmap): each
   leaf's change within 5e-2 relative norm, every element within
   2 x 3 x lr; then a planted fault (data shard 1's rows replaced by
   shard 0's) that the change bar must catch. It logs each rank's step
   wall and its collective seconds by kind (gather, reduce-scatter, TP
   all-reduce) beside the unsharded step's wall, its peak memory and bytes
   sent. Its launches (the reference's and the ranks') join the kernels
   line.
30. fsdp families -- in a fresh process (``chip_smoke.py --fsdp-families``;
   it runs alone too): phase 29's checks (``fsdp_run``, FSDP_FAMILIES), on
   one 2 x 2 mesh of four ranks, for mamba2-1.3b x2 (32 ssm heads of 64 a
   rank, state 128), zamba2-1.2b x12 (the shared block used twice: 16
   heads of 64 a rank; 32 ssm heads, state 64; float32 compute,
   ``FAMILY_CONFIG``) and qwen2-moe-a2.7b x1 (30 experts a rank, 8 heads
   of 128, capacity factor 1.25), full width, B=2, S=2048, 2
   AdamW steps. The moe's and the hybrid's attention is conditioned
   (``fsdp_init``) in the reference and in the ranks. Every step 0 flash
   and SSD call of a rank held to its plain version; each rank's sent
   bytes equal to the family's closed form; the 2-microbatch control for
   mamba2 and zamba2; planted faults on mamba2 (the rows of phase 29) and
   on qwen2-moe (the capacity from one data rank's rows, ``plant_fault``:
   at the phase's size no pair reaches the sound capacity, 384, but 256
   drops some). Then zamba2 x12 in bf16 compute, one SGD step at
   lr 1 (``fsdp_grad_check``): each leaf's gradient, sharded (its bf16
   flash and SSD calls held), unsharded and the unsharded at 2
   microbatches, against the float32 one. It logs each family's step
   wall, collective share and peak a rank. Its launches join the kernels
   line.
The full run starts phases 20 and 21 (``--moe``, ``--encdec``), 23, 24
and 30 (``--solvers``, ``--faults``, ``--fsdp-families``), and 25, 27 and
29 (``--sweep``, ``--sharded``, ``--fsdp``) side by side
(``side_by_side``): their checks time nothing that the kernels line
reports, and each group's memory fits on the card together (``--launch``
runs alone: its fitting cell takes 61 GB, and an rcv1-width z* solve
17.8 GB); their own step times are then taken beside each other's (run a
flag alone to time it).
Before phase 9, flash_attention_bwd is held to its plain version at the
train shape and at ragged small shapes (every head dim, GQA, MQA, window,
softcap), bf16 and f32 (bars 5e-2, 2e-4); its times come from the
attention-profile process.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: no phase catches its
own failure.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.dsba_paper import EXPERIMENTS  # noqa: E402
from repro_torch.core import mixing  # noqa: E402
from repro_torch.core.operators import FAMILIES  # noqa: E402
from repro_torch.core.solvers import (  # noqa: E402
    ChurnEvent, ChurnPlan, CheckpointManager, CheckpointSpec, FaultPlan, LinkFault,
    StragglerSpec, _advance, _dynamic_hp, _get_dense_runner, _phase_runner,
    available_solvers, clear_runner_caches, get_solver, link_delivered_mask, make_problem,
    runner_cache_stats, solve, solve_many, straggler_delivered_mask,
)
from repro_torch.core.dsba import DSBAConfig, draw_indices  # noqa: E402
from repro_torch.core.sparse_comm import (  # noqa: E402
    batch_tree, run_sparse, run_sparse_many, sparse_doubles_per_iter,
)
from repro_torch.data.synthetic import (  # noqa: E402
    DATASET_PRESETS, make_classification, make_regression,
)
from repro_torch.ckpt.checkpoint import committed_steps, load_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.sharded_loader import LoaderConfig, batch_at  # noqa: E402
from repro_torch.core.gossip import (  # noqa: E402
    GossipConfig, consensus_distance, gather_gossip_state, init_gossip_state,
    make_gossip_train_step, pod_digests, wire_bytes_per_pod,
)
from repro_torch.examples import (  # noqa: E402
    auc_maximization, decentralized_ridge, quickstart, serve_decode,
)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention, decode_plan  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    bwd_kernels, flash_attention, flash_attention_bwd, tile_plan,
)
from repro_torch.kernels.ref import (  # noqa: E402
    attention_ref, block_topk_ref, decode_attention_ref, decode_split_ranges,
    flash_attention_bwd_ref, magnitude_key, sparse_axpy_ref, sparse_dot_ref, ssd_chunk_bwd_ref,
    ssd_chunk_ref,
)
from repro_torch.kernels.sparse_saga import sparse_axpy, sparse_dot  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk_bwd, ssd_chunk_fwd, ssd_plan  # noqa: E402
from repro_torch.kernels.topk_compress import block_topk, topk_plan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cost_analysis import count_step, model_flops  # noqa: E402
from repro_torch.launch.shapes import ShapeSpec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map, tree_num_params  # noqa: E402
from repro_torch.optim.adam import AdamConfig  # noqa: E402
from repro_torch.serve import PoolConfig, Request, Scheduler, generate  # noqa: E402
from repro_torch.train import step as train_mod  # noqa: E402
from repro_torch.train.step import TrainConfig, init_train_state, local_grads, train_step  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate; float32 and float64
# (non-tensor-core) arithmetic rates and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12, torch.bfloat16: 989e12}
# the dense TF32 tensor-core rate: the SSD kernels' products (3 TF32 a float32 product)
TF32 = "tf32"
PEAK_OPS_PER_S[TF32] = 495e12

SOURCES = {
    "sparse_dot": "src/repro_torch/kernels/csrc/sparse_saga.cu",
    "sparse_axpy": "src/repro_torch/kernels/csrc/sparse_saga.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
    "block_topk": "src/repro_torch/kernels/csrc/topk_compress.cu",
    "ssd_chunk": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "ssd_chunk_bwd": "src/repro_torch/kernels/csrc/ssd_scan.cu",
}
REPLACES = {
    "sparse_dot": "src/repro/kernels/sparse_saga.py:56",
    "sparse_axpy": "src/repro/kernels/sparse_saga.py:122",
    "flash_attention": "src/repro/kernels/flash_attention.py:123",
    "decode_attention": "src/repro/kernels/decode_attention.py:116",
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:314",
    "block_topk": "src/repro/kernels/topk_compress.py:37",
    "ssd_chunk": "src/repro/kernels/ssd_scan.py:72",
    "ssd_chunk_bwd": "src/repro/kernels/ssd_scan.py:177",
}
WRAPPERS = {"sparse_dot": sparse_dot, "sparse_axpy": sparse_axpy,
            "flash_attention": flash_attention, "decode_attention": decode_attention,
            "flash_attention_bwd": flash_attention_bwd, "block_topk": block_topk,
            "ssd_chunk": ssd_chunk_fwd, "ssd_chunk_bwd": ssd_chunk_bwd}
DENSE_TOL_CPU = 1e-10  # card vs CPU: cuBLAS mixing-product summation order
SPARSE_TOL = 1e-12  # relay vs dense (tests/test_sparse_comm.py's bar)


def log(phase: str, msg: str) -> None:
    """One progress line on stdout."""
    print(f"[{phase}] {msg}", flush=True)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    """Current launch count of every kernel wrapper."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(n, d, k, dtype, device, seed=0, dups=True):
    """Seeded (psi, idx, val, coef, rho) on `device`.

    The last 3 entries of every row are padding (idx 0, val 0). With
    `dups`, indices are drawn with replacement (at k ~ D/6, as in
    init_state's phibar scatter, hundreds of columns repeat, in chunks far
    apart) and entries 1 and k//2 repeat entry 0's index; without, a row's
    indices are distinct.
    """
    pads = 3
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((n, d))
    if dups:
        idx = rng.integers(0, d, size=(n, k))
    else:
        idx = np.stack([rng.choice(d, size=k, replace=False) for _ in range(n)])
    val = rng.standard_normal((n, k))
    if dups and k > 2:
        idx[:, 1] = idx[:, 0]
        idx[:, k // 2] = idx[:, 0]
    idx[:, k - pads:] = 0
    val[:, k - pads:] = 0.0
    coef = rng.standard_normal(n)
    rho = rng.uniform(0.5, 1.5, n)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    return t(psi), t(idx, torch.int32), t(val), t(coef), t(rho)


def kernel_parity(device, shapes) -> dict[str, float]:
    """Every kernel vs its plain version at each (n, d, k) in `shapes`.

    float64 and float32, with padding; duplicates for sparse_axpy only
    (sparse_dot's data has distinct indices per row). Raises on a miss;
    returns the largest float64 error per kernel at the first shape.
    """
    worst = {}
    for i, (n, d, k) in enumerate(shapes):
        for dtype in (torch.float64, torch.float32):
            args = kernel_inputs(n, d, k, dtype, device, seed=i)
            e_axpy = ops.parity_check("sparse_axpy", *args, mode="auto")
            clean = kernel_inputs(n, d, k, dtype, device, seed=i, dups=False)
            e_dot = ops.parity_check("sparse_dot", *clean[:3], mode="auto")
            if device.type == "cuda":
                torch.cuda.synchronize()
            log("kernels", f"{str(dtype):14s} N={n} D={d} k={k}: "
                f"sparse_axpy max_abs_err={e_axpy!r} "
                f"sparse_dot max_abs_err={e_dot!r}")
            if i == 0 and dtype == torch.float64:
                worst = {"sparse_axpy": e_axpy, "sparse_dot": e_dot}
    return worst


def cuda_ms(fn, iters=200, warmup=20) -> float:
    """Milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
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


def device_profile(fn, iters):
    """Run ``fn`` `iters` times under torch.profiler.

    Returns (device busy microseconds, {kernel name: (device us, count)})
    summed over the CUDA kernel events of the window.
    """
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = {e.key: (e.device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}
    return sum(t for t, _ in kern.values()), kern


def replay_step(step, n=10, profiled=3) -> dict:
    """Wall (no profiler) ms of `step` over `n` calls; device-busy ms, idle
    share and launches (profiler) over `profiled` calls. A decode step
    repeats the same launches, and reading a profiled window's trace takes
    seconds a step (a serve step launches ~1,000-3,300 kernels)."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    busy_us, kern = device_profile(step, profiled)
    busy = busy_us / 1e3 / profiled
    return {"wall_ms": wall, "device_ms": busy, "idle_share": 1.0 - busy / wall,
            "launches": sum(c for _, c in kern.values()) / profiled,
            "top_kernels_us": top_by_prefix({k: t / profiled for k, (t, _) in kern.items()},
                                            6)}


def kernel_device_ms(fn, names, iters=50, windows=3):
    """Device milliseconds per call of ``fn``: for each CUDA kernel whose
    name contains one of `names`, its mean time per launch in a profiled
    window of `iters` calls, summed over those kernels (each is launched
    once per call). None when no window records every one of them.

    Late in a long process the profiler has come back with fewer kernel
    events than calls, or none: the mean is over the launches it recorded,
    and a window that misses one of the kernels is profiled again, up to
    `windows` times (each shortfall is logged)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        _, kern = device_profile(fn, iters)
        hits = [(t, c) for key, (t, c) in kern.items() if any(n in key for n in names)]
        if any(c != iters for _, c in hits) or len(hits) != len(names):
            log("profile", f"{names}: {[c for _, c in hits]} kernel events for "
                f"{iters} calls ({len(kern)} kernel names in the window)")
        if len(hits) == len(names):
            return sum(t / c for t, c in hits) / 1e3
    return None


def call_device_ms(fn, iters=50) -> float:
    """Device milliseconds per call of ``fn``, summed over every CUDA kernel
    it launches (profiler), after one warm call."""
    fn()
    torch.cuda.synchronize()
    _, kern = device_profile(fn, iters)
    return sum(t for t, _ in kern.values()) / iters / 1e3


def host_us(fn, calls=10_000) -> float:
    """Host microseconds a call of ``fn``: time.perf_counter over `calls`
    back-to-back calls with no synchronisation (the launch path alone while
    the device keeps up), after one synchronised warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def bound(nbytes: float, nops: float, dtype) -> tuple[float, str]:
    """(least milliseconds, 'bytes' | 'operations') for this much work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bound(name: str, *args, dtype, products: int = 1, **kwargs) -> tuple[float, str]:
    """``bound`` of the work the registry's ``KernelSpec.cost`` counts for
    this call of kernel `name` (each input read once, each output written
    once; the dry run counts the same), its operations at `dtype`'s rate,
    `products` of them an operation counted (3: the SSD kernels' TF32 split)."""
    nops, nbytes = ops.get_kernel(name).cost(*args, **kwargs)
    return bound(nbytes, products * nops, dtype)


def time_kernels(device, n, d, k, dtype=torch.float64) -> dict[str, dict]:
    """Kernel, plain version and library times at the main path's shape."""
    psi, idx, val, coef, rho = kernel_inputs(n, d, k, dtype, device, dups=False)
    out = {}

    b_axpy = kernel_bound("sparse_axpy", psi, idx, val, coef, rho, dtype=dtype)
    out["sparse_axpy"] = {
        "ms": cuda_ms(lambda: sparse_axpy(psi, idx, val, coef, rho)),
        # the kernels' own device time (ms above includes the host's launch
        # path whenever that is slower than the device)
        "device_ms": kernel_device_ms(lambda: sparse_axpy(psi, idx, val, coef, rho),
                                      ("sparse_axpy_kernel",)),
        "plain_ms": cuda_ms(lambda: sparse_axpy_ref(psi, idx, val, coef, rho), iters=50),
        "bound_ms": b_axpy[0], "bound_by": b_axpy[1],
        "library_ms": None,  # no single PyTorch call computes rho*psi + coef*scatter
    }

    b_dot = kernel_bound("sparse_dot", psi, idx, val, dtype=dtype)  # its distinct entries
    crow = torch.arange(0, n * k + 1, k, device=device)
    cols = (torch.arange(n, device=device)[:, None] * d + idx.long()).reshape(-1)
    csr = torch.sparse_csr_tensor(crow, cols, val.reshape(-1), size=(n, n * d))
    flat = psi.reshape(-1)
    lib_err = (csr @ flat - sparse_dot_ref(psi, idx, val)).abs().max().item()
    if lib_err > 1e-9:
        raise AssertionError(f"CSR library yardstick disagrees: {lib_err}")
    dot = lambda: sparse_dot(psi, idx, val)  # noqa: E731
    csr_dot = lambda: csr @ flat  # noqa: E731
    # events over back-to-back calls, in turns with the CSR call (the two
    # numbers the launch path is held to are taken in this one call)
    ms, lib_ms = [], []
    for _ in range(3):
        ms.append(cuda_ms(dot))
        lib_ms.append(cuda_ms(csr_dot))
    out["sparse_dot"] = {
        "ms": float(np.median(ms)),
        "device_ms": kernel_device_ms(dot, ("sparse_dot_kernel",)),
        "plain_ms": cuda_ms(lambda: sparse_dot_ref(psi, idx, val)),
        "bound_ms": b_dot[0], "bound_by": b_dot[1],
        "library_ms": float(np.median(lib_ms)),  # CSR sparse matrix x vector
        # the CSR call's own device time, every kernel it launches (profiler)
        "library_device_ms": call_device_ms(csr_dot),
        "ms_runs": ms, "library_ms_runs": lib_ms,
        # the host's cost a call: time.perf_counter over 10,000 calls, no sync
        "host_us": host_us(dot), "library_host_us": host_us(csr_dot),
    }
    for name, r in out.items():
        log("kernels", f"{name} N={n} D={d} k={k} {dtype}: {r}")
    return out


# the gossip step's largest selection: gemma2-2b's embedding leaf, 2 pods x
# 144,000 blocks of 4,096, k_b = 40 (1% of a block)
TOPK_MAIN = (2 * 144_000, 4096, 40)
# one long row a pod (a block_size of 1,000,003 at ratio 0.01): the "stream"
# variant, every pass from device memory
TOPK_LONG = (2, 1_000_003, 10_000)
# + final_norm (one block of 2304, k_b 23), the reduced configs' leaves
# (blocks of 64 and 16, k_b 1), k = block (staged and sorted in shared
# memory), blocks above 8,192 (staged at 8,193; stream at 65,536 and at
# TOPK_LONG)
TOPK_CASES = [TOPK_MAIN, (7, 2304, 23), (5, 64, 1), (3, 16, 16), (4, 4096, 4096),
              (3, 8193, 81), (2, 8192, 8192), (3, 65_536, 655), TOPK_LONG]
TOPK_KINDS = ("random", "ties", "constant", "nan")
# NaNs of several payloads and both signs, +-inf, +-0 (as uint32 bits)
TOPK_SPECIALS = (0x7FC00000, 0x7FC00005, 0xFFC00003, 0x7F800001, 0xFF812345, 0x7F800000,
                 0xFF800000, 0x80000000, 0x00000000)


def topk_rows(nb, block, kind, device, seed=0):
    """Seeded float32 rows: normal ('random'), rounded to halves ('ties':
    |x| in {0, 0.5, 1, ...}), constant ('constant': 1.0, odd rows -0.25) or
    normal with block // 100 (at least 1) entries a row replaced by
    ``TOPK_SPECIALS`` ('nan')."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(nb, block, generator=g, device=device)
    if kind == "ties":
        x = torch.round(x * 2) / 2
    elif kind == "constant":
        x = torch.full_like(x, 1.0)
        x[1::2] = -0.25
    elif kind == "nan":
        m = max(1, block // 100)
        bits = torch.tensor(np.array(TOPK_SPECIALS, np.uint32).view(np.int32), device=device)
        pos = torch.randint(0, block, (nb, m), generator=g, device=device)
        pick = torch.randint(0, len(TOPK_SPECIALS), (nb, m), generator=g, device=device)
        x.view(torch.int32).scatter_(1, pos, bits[pick])
    return x


def topk_parity(device) -> float:
    """block_topk against its plain version at every case and kind, one
    launch a call: within the registry's comparator (1e-6; not on 'nan',
    whose NaNs it cannot compare) and bit-equal in values (as bits) and
    indices. Returns the error at the main shape on random rows."""
    spec = ops.get_kernel("block_topk")
    worst = None
    for i, (nb, block, k) in enumerate(TOPK_CASES):
        for kind in TOPK_KINDS:
            x = topk_rows(nb, block, kind, device, seed=i)
            before = block_topk.launches
            got = ops.dispatch("block_topk", x, k, mode="on")
            launched = block_topk.launches - before
            want = ops.dispatch("block_topk", x, k, mode="off")
            torch.cuda.synchronize()
            err = (spec.compare((x, k), got, want, spec.tolerance(x.dtype))
                   if kind != "nan" else None)
            exact = (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                     and torch.equal(got[1], want[1]))
            log("kernels", f"block_topk nb={nb} block={block} k={k} {kind} "
                f"({topk_plan(block, k, nb)['variant']}): max_abs_err={err!r} "
                f"bit_equal={exact} launches={launched}")
            if not exact or launched != 1:
                raise AssertionError(f"block_topk ({nb}, {block}, {k}) {kind}: bit_equal={exact}, "
                                     f"{launched} launches")
            if i == 0 and kind == "random":
                worst = err
            del x, got, want
    return worst


def time_topk_shape(device, shape, iters) -> dict:
    """block_topk at one shape (random rows): kernel by events and by
    profiler device time, plain version, bound and torch.topk + gather (the
    same selection; its tie order may differ, so it is held by the
    registry's comparator, not bit for bit)."""
    nb, block, k = shape
    x = topk_rows(nb, block, "random", device)
    # one comparison an element is the least work a selection does
    b = kernel_bound("block_topk", x, k, dtype=torch.float32)
    kern = lambda: block_topk(x, k)  # noqa: E731

    def lib():
        i = torch.topk(x.abs(), k, dim=1).indices
        return torch.gather(x, 1, i), i.int()

    spec = ops.get_kernel("block_topk")
    spec.compare((x, k), lib(), kern(), spec.tolerance(x.dtype))
    out = {
        "ms": cuda_ms(kern, iters=iters, warmup=3),
        "device_ms": kernel_device_ms(kern, ("block_topk_",), iters=5),
        "plain_ms": cuda_ms(lambda: block_topk_ref(x, k), iters=3, warmup=1),
        "bound_ms": b[0], "bound_by": b[1],
        "library_ms": cuda_ms(lib, iters=max(3, iters // 2), warmup=2),
        "plan": topk_plan(block, k, nb),
    }
    log("kernels", f"block_topk nb={nb} block={block} k={k} float32: {json.dumps(out)}")
    return out


def time_topk(device) -> dict:
    """block_topk at the gossip step's embedding leaf (the kernels line's
    numbers), with the long row's numbers under ``long_row``."""
    out = time_topk_shape(device, TOPK_MAIN, iters=20)
    out["long_row"] = time_topk_shape(device, TOPK_LONG, iters=5)
    return out


# ---------------------------------------------------------------------------
# phases 4-5: the main path through solve()
# ---------------------------------------------------------------------------


def paper_problem(task, d, k, n_nodes=10, q=100, seed=0):
    """The Section-7 problem at preset widths (d, k): the data from_preset
    makes (regression rows for ridge and the bilinear saddle)."""
    if task in ("ridge", "bilinear"):
        data = make_regression(n_nodes, q, d, k, seed=seed)
    else:
        data = make_classification(n_nodes, q, d, k, seed=seed)
    graph = mixing.erdos_renyi_graph(n_nodes, 0.4, seed=seed)
    return make_problem(task, data, graph)


def expected_launches(steps: int, comm: str) -> dict[str, int]:
    """The kernel launches of one solve(): 1 sparse_axpy call for init,
    4 sparse_axpy + 1 sparse_dot calls a step and 1 more sparse_axpy call a
    relay step; each call of either launches one kernel."""
    axpy_calls = 1 + 4 * steps + (steps if comm == "sparse" else 0)
    return {"sparse_dot": steps, "sparse_axpy": axpy_calls}


def counted_solve(problem, method, comm, device, steps, total, **kw):
    """solve() with the launch counts set to 0 before and checked after."""
    reset_launches()
    res = solve(problem, method, comm, steps=steps, device=device, **kw)
    got = launches()
    if device.type == "cuda":
        want = expected_launches(steps, comm)  # and no other kernel
        if got != {**dict.fromkeys(got, 0), **want} or min(want.values()) == 0:
            raise AssertionError(f"{method}/{comm}: launches {got} != {want}")
        for name, c in got.items():
            total[name] = total.get(name, 0) + c
    if not np.all(np.isfinite(res.z)):
        raise AssertionError(f"{method}/{comm}: non-finite iterates")
    return res


def slice_runs(device, d, k, n_nodes=10, q=100, dense_steps=100,
               sparse_steps=100, record_every=50) -> tuple[dict, list]:
    """The main path: dense and sparse solve() for dsba/dsa x 3 families.

    Returns (launch totals over every run, one summary dict per run pair).
    """
    cpu = torch.device("cpu")
    total, rows = {}, []
    alphas = {t: EXPERIMENTS[f"{t}_rcv1"].alpha for t in ("ridge", "logistic", "auc")}
    for task in ("ridge", "logistic", "auc"):
        problem = paper_problem(task, d, k, n_nodes, q)
        g = problem.graph
        depth = max(3, g.diameter + 2)
        ring_mb = depth * n_nodes * n_nodes * problem.dim * 8 / 1e6
        log("slice", f"{task}: d={d} k={k} N={n_nodes} q={q} "
            f"diameter={g.diameter} ring depth={depth} ring={ring_mb:.1f} MB")
        for method in ("dsba", "dsa"):
            # dsba takes the paper's step size; dsa its solver default
            hp = {"alpha": alphas[task]} if method == "dsba" else {}
            t0 = time.perf_counter()
            dense = counted_solve(problem, method, "dense", device, dense_steps,
                                  total, record_every=record_every,
                                  keep_snapshots=True, **hp)
            t_dense = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref = solve(problem, method, "dense", steps=dense_steps,
                        record_every=record_every, device=cpu, **hp)
            t_cpu = time.perf_counter() - t0
            err_cpu = float(np.max(np.abs(dense.z - ref.z)))
            if err_cpu > DENSE_TOL_CPU:
                raise AssertionError(f"{task}/{method}: card vs CPU {err_cpu}")
            t0 = time.perf_counter()
            sparse = counted_solve(problem, method, "sparse", device, sparse_steps,
                                   total, record_every=record_every,
                                   comm_options={"verify": True}, **hp)
            t_sparse = time.perf_counter() - t0
            at = list(dense.iters).index(sparse_steps)
            err_sparse = float(np.max(np.abs(sparse.z - dense.zs[at])))
            if err_sparse > SPARSE_TOL:
                raise AssertionError(f"{task}/{method}: sparse vs dense {err_sparse}")
            per_iter = np.diff(sparse.doubles_received, axis=0) / np.diff(sparse.iters)[:, None]
            want = sparse_doubles_per_iter(n_nodes, k, problem.spec.tail_dim)
            if not np.all(per_iter[-1] == want):
                raise AssertionError(f"{task}/{method}: doubles/iter {per_iter[-1]} != {want}")
            row = {
                "task": task, "method": method, "alpha": hp.get("alpha", get_solver(method).defaults["alpha"]),
                "dense_card_vs_cpu": err_cpu, "sparse_vs_dense": err_sparse,
                "recon_max_err": sparse.extras["recon_max_err"],
                "doubles_per_iter": int(per_iter[-1][0]), "consensus": float(dense.consensus[-1]),
                "s_dense": t_dense, "s_dense_cpu": t_cpu, "s_sparse": t_sparse,
            }
            rows.append(row)
            log("slice", json.dumps(row))
    return total, rows


def profile_steps(device, d, k, steps=30) -> list[dict]:
    """Where a step's time goes at the paper's rcv1 setup (CUDA only).

    For `steps` dense dsba steps (ridge, logistic) and a `steps`-step ridge
    relay solve: wall ms per step without the profiler (host clock around a
    synchronized run), device busy ms per step from the profiler's kernel
    events, the idle share 1 - busy/wall, kernel launches per step, and the
    five kernels with the most device time.
    """
    i_t = torch.as_tensor(np.random.default_rng(0).integers(0, 100, (steps, 10)),
                          device=device)
    rows = []
    for task in ("ridge", "logistic"):
        problem = paper_problem(task, d, k)
        state0, step, hp_run, _ = bound_step(
            problem, "dsba", {"alpha": EXPERIMENTS[f"{task}_rcv1"].alpha}, device)

        def run(state=state0, step=step, hp_run=hp_run):
            for t in range(steps):
                state = step(state, i_t[t], hp_run)

        rows.append(_profile_row(f"dense dsba {task}", run, steps))
    problem = paper_problem("ridge", d, k)
    rows.append(_profile_row(
        "relay dsba ridge (whole solve incl. setup)",
        lambda: solve(problem, "dsba", "sparse", steps=steps, device=device),
        steps))
    return rows


def bound_step(problem, method, hp, device, link=None, strag=None, merged=None):
    """(initial state, step, hp_run, comm) of ``method`` on ``problem`` from
    the solver's runner cache, as ``solve()`` binds them (a fault runner
    with the ``link``/``strag`` masks bound when either is given), or with
    ``merged`` (one hp dict a run) as ``solve_many`` binds a batch."""
    spec = get_solver(method)
    hp = dict(spec.defaults, **hp)
    runner = _phase_runner(spec, problem, hp, device, link, strag)
    hp_run = _dynamic_hp(spec, problem, hp, runner.data.val.dtype, device, merged=merged)
    z0 = torch.zeros((problem.graph.n, problem.dim), dtype=runner.data.val.dtype, device=device)
    state0 = runner.init(z0)
    if merged is not None:
        state0 = batch_tree(state0, len(merged))
    return state0, runner.step, hp_run, runner.comm


def _profile_row(name, run, steps):
    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    busy_us, kern = device_profile(run, 1)
    busy_ms = busy_us / 1e3 / steps
    row = {"what": name, "wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
           "kernel_launches_per_step": sum(c for _, c in kern.values()) / steps,
           "top_kernels_us_per_step": top_by_prefix(
               {key: t / steps for key, (t, _) in kern.items()}, 5, 70)}
    log("profile", json.dumps(row))
    return row


def widest_run(device, d, k, steps=20) -> dict:
    """logistic_news20: dense dsba at the widest preset."""
    e = EXPERIMENTS["logistic_news20"]
    problem = paper_problem("logistic", d, k, e.n_nodes, e.q, e.seed)
    t0 = time.perf_counter()
    res = counted_solve(problem, "dsba", "dense", device, steps, {},
                        record_every=steps, alpha=e.alpha)
    out = {"d": d, "k": k, "steps": steps, "seconds": time.perf_counter() - t0,
           "consensus": float(res.consensus[-1]),
           "z_mb": res.z.size * res.z.itemsize / 1e6}
    log("widest", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 7-9: the dense model family (attention kernels, serve, score)
# ---------------------------------------------------------------------------

BF16_BAR = ops.get_kernel("decode_attention").tolerance(torch.bfloat16).atol  # 2e-2
SERVE_POOL = PoolConfig(max_batch=8, block_size=16, max_len=1024, prompt_pad=256,
                        n_blocks=8 * 64 + 1)


def within_bf16_bar(got, want) -> bool:
    """|got - want| <= bar + bar * |want| elementwise (the registry's bf16
    Tolerance, rtol = atol = 2e-2), computed on the card."""
    return bool(((got - want).abs() <= BF16_BAR + BF16_BAR * want.abs()).all())


def same_function(got, want) -> bool:
    """A library yardstick computes the same function: relative error norm
    within the bf16 bar (elementwise it rounds at other places, e.g. SDPA
    rounds the probabilities to bf16 before the value product)."""
    return (got - want).float().norm().item() <= BF16_BAR * want.float().norm().item()


def flash_inputs(b, hq, hkv, s, sk, d, dtype, device, seed=0):
    """Seeded (q, k, v) on `device`, heads-major."""
    g = torch.Generator(device=device).manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    return t(b, hq, s, d), t(b, hkv, sk, d), t(b, hkv, sk, d)


def decode_inputs(lengths, hq, hkv, d, n_blocks, bs, n_pages, dtype, device, seed=0):
    """Seeded (q, k_pool, v_pool, table, lengths): distinct pages per
    sequence, the null page 0 past each length."""
    g = torch.Generator(device=device).manual_seed(seed)
    b = len(lengths)
    q = torch.randn(b, hq, d, generator=g, device=device).to(dtype)
    kp = torch.randn(n_blocks, bs, hkv, d, generator=g, device=device).to(dtype)
    vp = torch.randn(n_blocks, bs, hkv, d, generator=g, device=device).to(dtype)
    rng = np.random.default_rng(seed)
    pages = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((b, n_pages), np.int32)
    used = 0
    for i, n in enumerate(lengths):
        need = -(-n // bs)
        table[i, :need] = pages[used:used + need]
        used += need
    return (q, kp, vp, torch.as_tensor(table, device=device),
            torch.as_tensor(np.asarray(lengths, np.int32), device=device))


# gemma2-2b's attention (8/4 heads, head_dim 256, causal, window 4096,
# softcap 50): the gossip step's shape, and one where the window bites
GEMMA2_ATTENTION = [(1, 8, 4, 2048, 2048, 256, True, 4096, 50.0),
                    (1, 8, 4, 4608, 4608, 256, True, 4096, 50.0)]


def attention_parity(device, decode_main) -> dict[str, float]:
    """Both attention kernels against their plain versions (raises on a
    miss); returns the bf16 error at the main path's shape per kernel."""
    flash_cases = [  # (B, Hq, Hkv, S, Sk, D, causal, window, softcap)
        (1, 32, 8, 2048, 2048, 128, True, None, None),  # the score phase's shape
        (2, 32, 8, 1000, 1000, 128, True, None, None),  # S not a tile multiple
        (1, 8, 2, 333, 333, 128, False, None, None),
        (1, 4, 4, 300, 300, 64, True, 100, None),
        (1, 4, 2, 257, 257, 128, True, None, 50.0),
        (2, 4, 1, 77, 129, 64, False, 40, 30.0),  # S < Sk, window without causal
        *GEMMA2_ATTENTION,
    ]
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for i, (b, hq, hkv, s, sk, d, causal, window, cap) in enumerate(flash_cases):
            q, k, v = flash_inputs(b, hq, hkv, s, sk, d, dtype, device, seed=i)
            err = ops.parity_check("flash_attention", q, k, v, causal=causal,
                                   window=window, softcap=cap, return_lse=True)
            torch.cuda.synchronize()
            log("attention", f"flash {dtype} B={b} Hq={hq} Hkv={hkv} S={s} Sk={sk} D={d} "
                f"causal={causal} window={window} softcap={cap}: max_abs_err={err!r}")
            if i == 0 and dtype == torch.bfloat16:
                worst["flash_attention"] = err
        decode_cases = [  # (lengths, Hq, Hkv, D, n_blocks, bs, n_pages, window, softcap)
            ([0, 1, 17, 1024, 16, 31, 300, 5], 32, 8, 128, 513, 16, 64, None, None),
            ([0, 1, 7, 48], 32, 1, 128, 40, 16, 3, None, None),  # MQA
            ([3, 20, 13, 0], 4, 2, 64, 24, 4, 5, 6, None),
            ([16, 9, 1], 8, 2, 128, 12, 4, 4, None, 15.0),
            ([19, 40, 0], 4, 1, 64, 30, 8, 5, 4, 25.0),
        ]
        for i, (lens, hq, hkv, d, nb, bs, npg, window, cap) in enumerate(decode_cases):
            args = decode_inputs(lens, hq, hkv, d, nb, bs, npg, dtype, device, seed=i)
            err = ops.parity_check("decode_attention", *args, window=window, softcap=cap)
            torch.cuda.synchronize()
            log("attention", f"decode {dtype} lengths={lens} Hq={hq} Hkv={hkv} D={d} "
                f"bs={bs} window={window} softcap={cap}: max_abs_err={err!r}")
    # the serve snapshot in the path's own dtype (its K/V reach ~100, far
    # from the unit scale the float32 bar is set for)
    err = ops.parity_check("decode_attention", *decode_main)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the wrapper never reads lengths to the host
    try:
        first, second = decode_attention(*decode_main), decode_attention(*decode_main)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    same = torch.equal(first, second)
    torch.cuda.synchronize()
    log("attention", f"decode {decode_main[0].dtype} at the serve snapshot "
        f"lengths={decode_main[4].tolist()}: max_abs_err={err!r} repeat_bit_equal={same}")
    if not same:
        raise AssertionError("decode_attention: two calls on the serve snapshot differ")
    worst["decode_attention"] = err
    decode_long_parity(device)
    return worst


# decode at long contexts with minitron-8b's heads (bf16, 32/8, D=128, pages
# of 16), every length 32,768: B = 8 (1.07 GB of K/V) and the reference's
# decode_32k shape, B = 128 (src/repro/launch/shapes.py; 17.2 GB)
DECODE_LONG = {"b8_32k": (8, 32_768), "decode_32k": (128, 32_768)}


def decode_long_inputs(b, length, device, seed=0):
    """Seeded bf16 (q, k_pool, v_pool, table, lengths), every length
    `length`: minitron-8b's heads, pages of 16 drawn as a random permutation
    of the pool (page 0 stays the null page)."""
    hq, hkv, d, bs = 32, 8, 128, 16
    n_pages = -(-length // bs)
    nb = b * n_pages + 1
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, hq, d, generator=g, device=device).to(torch.bfloat16)
    kp = torch.empty(nb, bs, hkv, d, dtype=torch.bfloat16, device=device).normal_(generator=g)
    vp = torch.empty_like(kp).normal_(generator=g)
    table = (torch.randperm(nb - 1, generator=g, device=device) + 1).int().reshape(b, n_pages)
    lengths = torch.full((b,), length, dtype=torch.int32, device=device)
    return q, kp, vp, table, lengths


def decode_rows(b):
    """The sequences a long shape's plain version is computed for: all of
    them up to 8, else 8 spread over the batch (the plain version's float32
    gather of all 128 of decode_32k would take 34 GB)."""
    return list(range(b)) if b <= 8 else list(range(0, b, b // 8))[:8]


# The long shapes are also held to a relative Frobenius error,
# ||got - want|| / ||want||. With N(0, 1) inputs the softmax over 32,768
# positions is nearly flat, each output element is ~0.009, and the registry's
# bar (0.02 + 0.02 |want|) would pass a kernel that skipped a tile or a whole
# split. Leaving out m of n positions moves the output by ~sqrt(m / n) of its
# norm (0.044 for one 64-position tile of 32,768); rounding the output to
# bf16 moves it by ~0.002.
DECODE_LONG_REL = 0.01


def rel_norm(got, want) -> float:
    """||got - want|| / ||want||, in float32."""
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def decode_long_faults(q, kp, vp, table, lengths, tile, splits) -> dict:
    """The plain version of what a split kernel would give if it left out
    part of each sequence's positions (every length equal): its last tile,
    and, with splits > 1, its first split (a window that starts where the
    second split does). Each must miss DECODE_LONG_REL, which shows that the
    bar catches such a fault at these inputs."""
    length = int(lengths[0])
    faults = {"last tile skipped": decode_attention_ref(q, kp, vp, table, lengths - tile)}
    if splits > 1:
        second = decode_split_ranges(length, table.shape[1] * kp.shape[1], None, tile, splits)[1]
        faults["first split dropped"] = decode_attention_ref(q, kp, vp, table, lengths,
                                                             window=length - second[0])
    return faults


def decode_long_parity(device) -> None:
    """decode_attention at DECODE_LONG against its plain version: the bf16
    bar and DECODE_LONG_REL, over the whole batch at B = 8 and 8 of the 128
    sequences at decode_32k; the plain version of a skipped tile and of a
    dropped split must each miss DECODE_LONG_REL; two calls bit-equal (the
    deterministic merge of the splits)."""
    tol = ops.get_kernel("decode_attention").tolerance(torch.bfloat16)
    for name, (b, length) in DECODE_LONG.items():
        q, kp, vp, table, lengths = decode_long_inputs(b, length, device)
        plan = decode_plan(b, kp.shape[2], q.shape[1] // kp.shape[2], q.shape[2], q.dtype,
                           table.shape[1], kp.shape[1], _build.sm_count(q.device))
        before = decode_attention.launches
        got = decode_attention(q, kp, vp, table, lengths)
        again = decode_attention(q, kp, vp, table, lengths)
        launched = decode_attention.launches - before
        rows = torch.tensor(decode_rows(b), device=device)
        sub = (q[rows], kp, vp, table[rows], lengths[rows])
        want = decode_attention_ref(*sub)
        err = ops.assert_close(got[rows], want, tol)
        rel = rel_norm(got[rows], want)
        faults = {k: rel_norm(v, want) for k, v in
                  decode_long_faults(*sub, plan["tile"], plan["splits"]).items()}
        same = torch.equal(got, again)
        torch.cuda.synchronize()
        log("attention", f"decode bf16 {name} B={b} lengths={length}: max_abs_err={err!r} "
            f"rel_norm={rel!r} (limit {DECODE_LONG_REL}; plain version with a fault: "
            f"{json.dumps(faults)}) over {len(rows)} sequences, repeat_bit_equal={same}, "
            f"launches={launched}, splits={plan['splits']}")
        if not same or launched != 2:
            raise AssertionError(f"decode {name}: repeat_bit_equal={same}, {launched} launches")
        if not rel <= DECODE_LONG_REL:
            raise AssertionError(f"decode {name}: relative error {rel} > {DECODE_LONG_REL}")
        if not min(faults.values()) > DECODE_LONG_REL:
            raise AssertionError(f"decode {name}: a fault's plain version is within "
                                 f"{DECODE_LONG_REL}: {faults}")
        del q, kp, vp, table, lengths, got, again, want, sub
        torch.cuda.empty_cache()


def decode_split_count(q, kp, table) -> int:
    """The splits decode_attention's plan takes for these inputs."""
    b, hq, d = q.shape
    hkv = kp.shape[2]
    return decode_plan(b, hkv, hq // hkv, d, q.dtype, table.shape[1], kp.shape[1],
                       _build.sm_count(q.device))["splits"]


# the bf16 kernels' names in the profiler (the main paths' dtype): the
# forward's, and the backward's two at a head dim (wgmma at 64 and 128,
# mma.sync at 16, 32 and 256)
FLASH_FWD_KERNELS = ("flash_fwd_wgmma_kernel",)


def flash_bwd_kernels(d: int) -> tuple[str, ...]:
    """The bf16 backward's kernel names at head dim `d` (dq, then dk/dv)."""
    return tuple(bwd_kernels(tile_plan(torch.bfloat16, d)))


def time_attention(device, b=1, hq=32, hkv=8, s=2048, d=128, causal=True) -> dict:
    """The flash forward at the score phase's shape (bf16, B=1, 32/8 heads,
    S=2048, D=128, causal; or the one given, S = Sk): kernel, plain version
    and SDPA, beside the bound."""
    q, k, v = flash_inputs(b, hq, hkv, s, s, d, torch.bfloat16, device)
    # over the pairs this run's mask keeps
    bound_f = kernel_bound("flash_attention", q, k, v, causal, dtype=torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    plain_out = attention_ref(q, k, v, causal=causal)
    if not same_function(lib_out, plain_out):
        raise AssertionError("SDPA yardstick disagrees with the plain version: "
                             f"{(lib_out.float() - plain_out.float()).abs().max().item()}")
    del lib_out, plain_out
    fwd = lambda: flash_attention(q, k, v, causal)  # noqa: E731
    out = {
        "ms": cuda_ms(fwd, iters=50, warmup=5),
        "device_ms": kernel_device_ms(fwd, FLASH_FWD_KERNELS, iters=10),
        "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, causal=causal), iters=5, warmup=1),
        "bound_ms": bound_f[0], "bound_by": bound_f[1],
        "library_ms": cuda_ms(lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True),
                              iters=50, warmup=5),
    }
    log("attention-profile", f"flash_attention B={b} {hq}/{hkv} heads S={s} D={d} "
        f"causal={causal}: {json.dumps(out)}")
    return out


DECODE_KERNELS = ("flash_decode_kernel",)


def time_decode_shape(device, args, label, iters) -> dict:
    """decode_attention (bf16) on `args`: CUDA events, profiler device time,
    the bound, the plain version (on ``decode_rows`` of the batch: the
    share it covers is logged) and SDPA over the pages gathered beforehand
    (the gather is not timed; skipped when the card lacks the memory)."""
    qd, kp, vp, table, lengths = args
    B, Hq, D = qd.shape
    hkv = kp.shape[2]
    live = int(lengths.clamp(min=0).sum())
    esize = kp.element_size()
    bound_d = kernel_bound("decode_attention", *args, dtype=torch.bfloat16)  # its live positions
    rows = torch.tensor(decode_rows(B), device=device)
    sub = (qd[rows], kp, vp, table[rows], lengths[rows])
    kern = lambda: decode_attention(*args)  # noqa: E731
    out = {
        "ms": cuda_ms(kern, iters=iters, warmup=max(3, iters // 10)),
        "device_ms": kernel_device_ms(kern, DECODE_KERNELS, iters=min(50, iters)),
        "plain_ms": cuda_ms(lambda: decode_attention_ref(*sub), iters=max(3, iters // 10),
                            warmup=1),
        "plain_rows": f"{len(rows)} of {B}",
        "bound_ms": bound_d[0], "bound_by": bound_d[1],
        "library_ms": None,
        "splits": decode_split_count(qd, kp, table),
        "live_positions": live,
    }
    L = table.shape[1] * kp.shape[1]
    gathered = 2 * B * L * hkv * D * esize
    if torch.cuda.mem_get_info(device)[0] > 1.5 * gathered + (2 << 30):
        kg = kp[table.long()].reshape(B, L, hkv, D).transpose(1, 2)
        vg = vp[table.long()].reshape(B, L, hkv, D).transpose(1, 2)
        mask = (torch.arange(L, device=device)[None] < lengths[:, None].long())[:, None, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = lambda: sdpa(qd[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True)  # noqa: E731
        lib_out = lib()[rows, :, 0].float()
        plain_out = decode_attention_ref(*sub).float()
        if not same_function(lib_out, plain_out):
            raise AssertionError(f"SDPA decode yardstick disagrees at {label}: "
                                 f"{(lib_out - plain_out).abs().max().item()}")
        out["library_ms"] = cuda_ms(lib, iters=iters, warmup=max(3, iters // 10))
        del kg, vg, mask, lib_out, plain_out
        torch.cuda.empty_cache()
    log("decode-profile", f"decode_attention {label}: {json.dumps(out)}")
    return out


# the busiest decode step's lengths (+1: the token being decoded) of the
# serve phase (1,862 live positions), for a --decode-profile run on its
# own; the full run passes the ones its serve phase logged
SERVE_BUSIEST_LENGTHS = [170, 251, 253, 238, 285, 194, 247, 224]


def decode_profile(device, lengths=None) -> dict:
    """``chip_smoke.py --decode-profile [LENGTHS_JSON]`` (a fresh process;
    late in the main process torch.profiler drops kernel events):
    decode_attention at a serve snapshot (minitron-8b's heads over the serve
    pool's shape, the busiest step's `lengths`), at B = 8 and at decode_32k
    (every length 32,768): events, device time, bound, plain version, SDPA
    where memory allows, splits."""
    log("decode-profile", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    built = _build.build_all()
    log("decode-profile", "ptxas: " + json.dumps(
        {k: v for k, v in ptxas_report(built).items() if k.startswith("flash_decode")}))
    lengths = lengths or SERVE_BUSIEST_LENGTHS
    snap = decode_inputs(lengths, 32, 8, 128, SERVE_POOL.n_blocks, SERVE_POOL.block_size,
                         SERVE_POOL.max_len // SERVE_POOL.block_size, torch.bfloat16, device)
    out = time_decode_shape(device, snap, "serve snapshot", iters=200)
    out["lengths"] = list(lengths)
    del snap
    out["long"] = {}
    for name, (b, length) in DECODE_LONG.items():
        args = decode_long_inputs(b, length, device)
        out["long"][name] = time_decode_shape(device, args, name,
                                              iters=50 if b <= 8 else 10)
        del args
        torch.cuda.empty_cache()
    return out


SERVE_REQUESTS = 12  # 1.5 x the pool's slots: admissions wait for a slot


def serve_requests(cfg, n=SERVE_REQUESTS, seed=0) -> list[Request]:
    """`n` requests: prompts of 16-256 tokens, 16-64 new tokens."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, int(rng.integers(16, 257))),
                    int(rng.integers(16, 65))) for i in range(n)]


def on_vs_off_decode(sch, cfg, checked_steps, errs, first_step):
    """A decode_fn for `sch` that, for the first `checked_steps` decode
    steps, runs the step with decode_kernel "off" first and records the max
    abs logit difference of the live slots to the "on" step that follows
    ("on" rewrites the same pool entries, so both read one pool state);
    it keeps request 0's first decode-step logits in `first_step`."""
    cfg_off = dataclasses.replace(cfg, decode_kernel="off")
    inner = sch.decode_fn

    def decode_fn(params, tokens, pools, table, lengths):
        check = len(errs) < checked_steps
        if check:
            _, want = T.decode_step_paged(cfg_off, params, tokens, pools, table, lengths)
        out = inner(params, tokens, pools, table, lengths)
        live = list(sch._admit_order)
        if check:
            errs.append(((out[1][live] - want[live]).abs().max().item(),
                         within_bf16_bar(out[1][live], want[live])))
        for slot in live:
            st = sch.active[slot]
            if st.req.rid == 0 and len(st.generated) == 1:
                first_step["logits"] = out[1][slot].float().clone()
        return out

    return decode_fn


def serve_phase(device, cfg, params) -> tuple[dict, tuple, dict]:
    """The Scheduler at full width with the port's own random init.

    Hard checks: tokens, launches, an unmoved pool, and each layer's
    decode_attention call of the first 4 decode steps held to the plain
    version on its own inputs. The end-to-end logit differences (on vs off,
    paged vs contiguous) are reported: with this init they are chaotic (see
    ``conditioned_phase``). Returns (summary, decode snapshot (q, k_pool,
    v_pool, table, lengths) of layer 0 at the busiest step, launches).
    """
    sch = Scheduler(cfg, params, SERVE_POOL, device=device)
    ptrs = sch.pool.data_ptrs()
    reqs = serve_requests(cfg)
    mode_errs, first_step, busiest, layer_errs = [], {}, {}, []
    compare = on_vs_off_decode(sch, cfg, 4, mode_errs, first_step)

    def decode_fn(params_, tokens, pools, table, lengths):
        if len(layer_errs) < 4:
            with ops.held_to_plain("decode_attention") as errs:
                out = compare(params_, tokens, pools, table, lengths)
            layer_errs.append(max(errs))
        else:
            out = compare(params_, tokens, pools, table, lengths)
        live_tokens = int(lengths.sum())
        if live_tokens > busiest.get("live", -1):
            busiest.update(live=live_tokens, table=table.clone(), lengths=lengths.clone(),
                           tokens=tokens.clone())
        return out

    sch.decode_fn = decode_fn
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, stats = sch.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launches()
    want = stats.decode_steps * cfg.n_layers
    if got["decode_attention"] != want or want == 0:
        raise AssertionError(f"decode_attention launches {got} != {want}")
    if got["flash_attention"] != 0:  # prefill passes a cache: the inline path
        raise AssertionError(f"flash_attention launched in the serve phase: {got}")
    for r in reqs:
        toks = results[r.rid]
        if toks.shape != (r.max_new_tokens,) or not np.all((0 <= toks) & (toks < cfg.vocab_size)):
            raise AssertionError(f"request {r.rid}: tokens {toks.shape}")
    if sch.pool.data_ptrs() != ptrs:
        raise AssertionError("the pool was reallocated")
    r0 = reqs[0]
    gen = generate(cfg, params, torch.as_tensor(r0.tokens, device=device)[None],
                   max_new_tokens=1)
    paged_err = (first_step["logits"] - gen.logits[1][0]).abs().max().item()

    # a decode step at the busiest state, replayed (the pages are free
    # again, so the replay's writes land in unused pages)
    args = (params, busiest["tokens"], sch.pool.pools, busiest["table"], busiest["lengths"])
    step = replay_step(lambda: T.decode_step_paged(cfg, *args))
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)
                       if t.dtype == cfg.compute_dtype)
    n_tokens = int(sum(len(v) for v in results.values()))
    summary = {
        "requests": len(reqs), "tokens": n_tokens,
        "decode_steps": stats.decode_steps, "preemptions": stats.preemptions,
        "peak_active": stats.peak_active, "peak_occupancy": stats.peak_occupancy,
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "decode_ms_per_step_incl_admission": wall * 1e3 / stats.decode_steps,
        "kernel_vs_plain_per_layer_max_abs": layer_errs,
        "reported_on_vs_off_logits_max_abs": [e for e, _ in mode_errs],
        "reported_on_vs_off_within_bar": [ok for _, ok in mode_errs],
        "reported_paged_vs_contiguous_max_abs": paged_err,
        "reported_paged_vs_contiguous_same_first_token": int(gen.tokens[0, 0]) == int(results[0][0]),
        "busiest_live_tokens": busiest["live"], "decode_step": step,
        "weight_bytes_read_per_step": weight_bytes,
        "decode_step_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
    }
    log("serve", json.dumps(summary))
    gen_q = torch.Generator(device=device).manual_seed(1)
    snap = (torch.randn(SERVE_POOL.max_batch, cfg.n_heads, cfg.head_dim, device=device,
                        generator=gen_q).to(cfg.compute_dtype),
            sch.pool.pools["k"][0], sch.pool.pools["v"][0],
            busiest["table"], busiest["lengths"] + 1)
    return summary, snap, got


def score_tokens(cfg, device, s):
    """One seeded (1, s) token batch."""
    return torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, s)),
                           device=device)


def score_phase(device, cfg, params, s=2048) -> tuple[dict, dict]:
    """forward() at full width, B=1, with the port's own random init: 32
    flash_attention launches, each held to the plain version on its own
    inputs; finite logits. The on vs off logit difference is reported."""
    tokens = score_tokens(cfg, device, s)
    cfg_on = dataclasses.replace(cfg, attention_kernel="on")
    cfg_off = dataclasses.replace(cfg, attention_kernel="off")
    T.forward(cfg_on, params, tokens[:, :128])  # warm-up (cuBLAS plans)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on = T.forward(cfg_on, params, tokens)
    torch.cuda.synchronize()
    t_on = time.perf_counter() - t0
    got = launches()
    if got["flash_attention"] != cfg.n_layers or got["decode_attention"] != 0:
        raise AssertionError(f"score launches {got}: want {cfg.n_layers} flash_attention")
    if on.shape != (1, s, cfg.vocab_size) or not torch.isfinite(on).all():
        raise AssertionError(f"score logits {tuple(on.shape)} not finite")
    with ops.held_to_plain("flash_attention") as layer_errs:
        T.forward(cfg_on, params, tokens)
    if len(layer_errs) != cfg.n_layers:
        raise AssertionError(f"{len(layer_errs)} flash calls held to the plain version")
    t0 = time.perf_counter()
    off = T.forward(cfg_off, params, tokens)
    torch.cuda.synchronize()
    t_off = time.perf_counter() - t0
    out = {"B": 1, "S": s, "seconds_on": t_on, "seconds_off": t_off,
           "tokens_per_s_on": s / t_on,
           "kernel_vs_plain_per_layer_max_abs": max(layer_errs),
           "reported_on_vs_off_logits_max_abs": (on - off).abs().max().item(),
           "reported_on_vs_off_within_bar": within_bf16_bar(on, off),
           "logits_abs_max": off.abs().max().item()}
    log("score", json.dumps(out))
    return out, got


def condition_attention(cfg, attn) -> None:
    """Rescale the attention projections `attn` (stacked, or the hybrid's
    shared block) in place to a 1/sqrt(fan_in) init over the contracted
    width (d_model for wq, wk, wv; q_dim for wo).

    The reference's ParamDef takes shape[-2] as fan_in, which for the 3-D
    attention weights is the head count (32, 8) or head_dim (128): at
    minitron-8b's width the scores then have a standard deviation of about
    256, softmax is nearly an argmax, and a one-ulp bf16 change of one
    layer's attention output flips later layers' argmax: whole-model logits
    are a chaotic function of the attention outputs. With this scale the
    scores are O(1) and logits are a smooth function of them."""
    d, q_dim = cfg.d_model, cfg.q_dim
    with torch.no_grad():
        attn["wq"].mul_(math.sqrt(cfg.n_heads / d))
        attn["wk"].mul_(math.sqrt(cfg.n_kv_heads / d))
        attn["wv"].mul_(math.sqrt(cfg.n_kv_heads / d))
        attn["wo"].mul_(math.sqrt(cfg.head_dim / q_dim))


def conditioned_phase(device, cfg, params, s=2048) -> dict:
    """End-to-end logit checks on the conditioned weights (hard checks):
    the first 4 serve decode steps on vs off within the bf16 bar; request
    0's first decode step, paged vs the contiguous generate(), within the
    bf16 bar times the layer count (test_serve.py's rule for logits that see
    one attention tolerance through every layer); forward at S=2048 on vs
    off within the bf16 bar."""
    condition_attention(cfg, params["blocks"]["attn"])
    sch = Scheduler(cfg, params, SERVE_POOL, device=device)
    reqs = serve_requests(cfg)
    for r in reqs:
        sch.submit(r)
    mode_errs, first_step = [], {}
    sch.decode_fn = on_vs_off_decode(sch, cfg, 4, mode_errs, first_step)
    for _ in range(4):
        sch.step()
    if not all(ok for _, ok in mode_errs) or len(mode_errs) != 4:
        raise AssertionError(f"decode on vs off logits outside the bf16 bar: {mode_errs}")
    gen = generate(cfg, params, torch.as_tensor(reqs[0].tokens, device=device)[None],
                   max_new_tokens=1)
    slot0 = next(sl for sl, st in sch.active.items() if st.req.rid == 0)
    if int(gen.tokens[0, 0]) != int(sch.active[slot0].generated[0]):
        raise AssertionError("request 0: paged and contiguous prefill pick other tokens")
    paged_err = (first_step["logits"] - gen.logits[1][0]).abs().max().item()
    paged_bar = BF16_BAR * cfg.n_layers
    if paged_err > paged_bar:
        raise AssertionError(f"request 0: paged vs contiguous {paged_err} > {paged_bar}")
    tokens = score_tokens(cfg, device, s)
    on = T.forward(dataclasses.replace(cfg, attention_kernel="on"), params, tokens)
    off = T.forward(dataclasses.replace(cfg, attention_kernel="off"), params, tokens)
    if not within_bf16_bar(on, off):
        raise AssertionError(f"score on vs off {(on - off).abs().max().item()}")
    out = {"decode_on_vs_off_logits_max_abs": [e for e, _ in mode_errs],
           "paged_vs_contiguous_max_abs": paged_err, "paged_vs_contiguous_bar": paged_bar,
           "score_on_vs_off_max_abs": (on - off).abs().max().item(),
           "score_on_vs_off_rel_norm": ((on - off).norm() / off.norm()).item(),
           "score_logits_abs_max": off.abs().max().item()}
    log("conditioned", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 11-12: training (flash_attention_bwd, the train step, the launcher)
# ---------------------------------------------------------------------------

TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2, 2048, 5
GRAD_BAR = ops.get_kernel("flash_attention").grad_tolerance(torch.bfloat16).atol  # 5e-2


def flash_bwd_parity(device) -> float:
    """flash_attention_bwd against its plain version (raises on a miss);
    returns the bf16 error at the train step's shape."""
    cases = [  # (B, Hq, Hkv, S, Sk, D, causal, window, softcap)
        (TRAIN_B, 32, 8, TRAIN_S, TRAIN_S, 128, True, None, None),  # the train step's shape
        (2, 32, 8, 1000, 1000, 128, True, None, None),  # S not a tile multiple
        (1, 8, 2, 333, 333, 128, False, None, None),
        (1, 4, 4, 300, 300, 64, True, 100, None),
        (1, 4, 2, 257, 257, 128, True, None, 50.0),
        (2, 4, 1, 77, 129, 64, False, 40, 30.0),  # S < Sk, window without causal
        (1, 4, 2, 130, 130, 256, True, None, None),
        (2, 4, 2, 64, 64, 16, True, 7, None),  # the launcher's reduced head_dim
        *GEMMA2_ATTENTION,
    ]
    worst = None
    for dtype in (torch.bfloat16, torch.float32):
        for i, (b, hq, hkv, s, sk, d, causal, window, cap) in enumerate(cases):
            q, k, v = flash_inputs(b, hq, hkv, s, sk, d, dtype, device, seed=10 + i)
            do = flash_inputs(b, hq, hq, s, s, d, dtype, device, seed=30 + i)[0]
            o, lse = flash_attention(q, k, v, causal, window, cap, return_lse=True)
            err = ops.parity_check("flash_attention_bwd", q, k, v, o, lse, do, causal=causal,
                                   window=window, softcap=cap)
            torch.cuda.synchronize()
            log("attention", f"flash_bwd {dtype} B={b} Hq={hq} Hkv={hkv} S={s} Sk={sk} D={d} "
                f"causal={causal} window={window} softcap={cap}: max_abs_err={err!r}")
            if i == 0 and dtype == torch.bfloat16:
                worst = err
    return worst


def time_flash_bwd(device, b=TRAIN_B, hq=32, hkv=8, s=TRAIN_S, d=128, causal=True) -> dict:
    """flash_attention_bwd at the train step's shape (bf16; or the one
    given, S = Sk): kernel, plain version and SDPA's backward, beside the
    bound."""
    q, k, v = flash_inputs(b, hq, hkv, s, s, d, torch.bfloat16, device)
    do = flash_inputs(b, hq, hq, s, s, d, torch.bfloat16, device, seed=1)[0]
    o, lse = flash_attention(q, k, v, causal, return_lse=True)
    # five products over the pairs this run's mask keeps (s, dp, dq, dk, dv)
    bound_b = kernel_bound("flash_attention_bwd", q, k, v, o, lse, do, causal,
                           dtype=torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, is_causal=causal, enable_gqa=True)
    lib = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
    plain = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for got, want in zip(lib(), plain):
        if not same_function(got, want):
            raise AssertionError("SDPA backward yardstick disagrees with the plain version: "
                                 f"{(got.float() - want.float()).abs().max().item()}")
    del plain
    kern = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal)  # noqa: E731
    out_t = {
        "ms": cuda_ms(kern, iters=20, warmup=3),
        "device_ms": kernel_device_ms(kern, flash_bwd_kernels(d), iters=5),
        "plain_ms": cuda_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal),
                            iters=3, warmup=1),
        "bound_ms": bound_b[0], "bound_by": bound_b[1],
        "library_ms": cuda_ms(lib, iters=20, warmup=3),
    }
    split = {n: kernel_device_ms(kern, (n,), iters=5) for n in flash_bwd_kernels(d)}
    log("attention-profile", f"flash_attention_bwd B={b} {hq}/{hkv} heads S={s} D={d} "
        f"causal={causal}: "
        f"{json.dumps(out_t)}; device ms by kernel {json.dumps(split)}")
    return out_t


def train_config():
    """minitron-8b at full width, cut to TRAIN_LAYERS layers."""
    return dataclasses.replace(get_config("minitron-8b"), n_layers=TRAIN_LAYERS)


def expected_train_launches(cfg) -> dict[str, int]:
    """Kernel launches of one train step with remat 'full': the forward
    kernel twice a layer (forward, recompute), the backward's two kernels
    once a layer, and no other kernel."""
    want = dict.fromkeys(WRAPPERS, 0)
    want.update(flash_attention=2 * cfg.n_layers, flash_attention_bwd=2 * cfg.n_layers)
    return want


def train_phase(device) -> tuple[dict, dict, dict]:
    """TRAIN_STEPS steps of the launcher's wiring at full width.

    Returns (summary, launches over every step, the train state)."""
    cfg = train_config()
    tc = TrainConfig(optimizer=AdamConfig())  # launch/train.py's defaults
    ld = LoaderConfig(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, tc, 0, device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves({"p": state["params"], "o": state["opt"]})) / 1e9
    log("train", f"{cfg.name} x{cfg.n_layers} layers, {cfg.param_count()} params, "
        f"train state (params, mu, nu) {state_gb:.2f} GB, drawn in {t_init:.1f} s")
    want = expected_train_launches(cfg)
    total = dict.fromkeys(WRAPPERS, 0)
    losses, gnorms, walls, per_step = [], [], [], []

    def one_step(i):
        nonlocal state
        before = launches()
        state, m = train_step(cfg, tc, state, batch_at(ld, i))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        got = {n: c - before[n] for n, c in launches().items()}
        if got != want:
            raise AssertionError(f"train step {i}: launches {got} != {want}")
        for n, c in got.items():
            total[n] += c
        per_step.append({n: c for n, c in got.items() if c})

    reset_launches()
    t0 = time.perf_counter()
    with ops.held_to_plain("flash_attention") as fwd_errs, \
            ops.held_to_plain("flash_attention_bwd") as bwd_errs:
        one_step(0)
    torch.cuda.synchronize()
    t_held = time.perf_counter() - t0
    if len(fwd_errs) != 2 * cfg.n_layers or len(bwd_errs) != cfg.n_layers:
        raise AssertionError(f"step 0 held {len(fwd_errs)} forward and {len(bwd_errs)} "
                             "backward calls to the plain version")
    peak_step0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(1, TRAIN_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    busy_us, kern = device_profile(lambda: one_step(TRAIN_STEPS - 1), 1)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"train losses {losses} grad norms {gnorms}")
    wall_ms = float(np.median(walls)) * 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    summary = {
        "layers": cfg.n_layers, "B": TRAIN_B, "S": TRAIN_S, "tokens_per_step": TRAIN_B * TRAIN_S,
        "train_state_gb": state_gb, "losses": losses, "grad_norms": gnorms,
        "step0_s_held_to_plain": t_held,
        "step0_flash_fwd_vs_plain_max_abs": fwd_errs, "step0_flash_bwd_vs_plain_max_abs": bwd_errs,
        # the gradients' own size beside their errors (a mean loss over
        # 4,096 tokens makes them small), and the scale-free error held to
        # the same bar
        "step0_flash_bwd_plain_max_abs_grad": bwd_errs.scale,
        "step0_flash_bwd_vs_plain_rel_norm": bwd_errs.rel,
        "step0_flash_fwd_vs_plain_rel_norm": fwd_errs.rel,
        "step_wall_ms": [w * 1e3 for w in walls], "step_wall_ms_median": wall_ms,
        "tokens_per_s": TRAIN_B * TRAIN_S / (wall_ms / 1e3),
        "step_device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "kernel_launches_per_step_profiled": sum(c for _, c in kern.values()),
        # the profiler has dropped kernel events late in long runs: these
        # counts, against port_kernel_launches_per_step, say whether it did
        "profiled_port_kernels": {key[:40]: c for key, (_, c) in kern.items()
                                  if "flash_" in key and "_kernel" in key},
        "port_kernel_launches_per_step": per_step[-1],
        "peak_gb_steps_1_4": peak / 1e9, "peak_gb_step0_held": peak_step0 / 1e9,
        "top_kernels_us_per_step": {key[:60]: t for key, (t, _) in top},
    }
    log("train", json.dumps(summary))
    return summary, total, state


def train_on_off(state) -> dict:
    """One local_grads with attention_kernel "on" against "off" on the train
    parameters after ``condition_attention`` (hard checks: loss within 1e-3
    relative, every gradient leaf within the bf16 gradient bar in relative
    Frobenius norm; per-layer norms reported)."""
    cfg = train_config()
    del state["opt"]  # the moments are not needed here: room for two gradients
    gc.collect()
    torch.cuda.empty_cache()
    params = state["params"]
    condition_attention(cfg, params["blocks"]["attn"])
    tc = TrainConfig(optimizer=AdamConfig())
    batch = batch_at(LoaderConfig(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0), 0)
    l_on, g_on = local_grads(dataclasses.replace(cfg, attention_kernel="on"), tc, params, batch)
    l_off, g_off = local_grads(dataclasses.replace(cfg, attention_kernel="off"), tc, params,
                               batch)
    loss_rel = abs(float(l_on) - float(l_off)) / abs(float(l_off))
    rel, per_layer = {}, {}

    def walk(a, b, path=()):
        if isinstance(a, dict):
            for key in a:
                walk(a[key], b[key], (*path, key))
            return
        name = "/".join(path)
        rel[name] = ((a - b).norm() / b.norm()).item()
        if path[0] == "blocks":
            per_layer[name] = [((a[i] - b[i]).norm() / b[i].norm()).item()
                               for i in range(a.shape[0])]

    walk(g_on, g_off)
    out = {"loss_on": float(l_on), "loss_off": float(l_off), "loss_rel": loss_rel,
           "grad_rel_norm": rel, "grad_rel_norm_per_layer": per_layer}
    log("train", f"on vs off: {json.dumps(out)}")
    if loss_rel > 1e-3 or max(rel.values()) > GRAD_BAR:
        raise AssertionError(f"train on vs off: loss {loss_rel}, worst leaf "
                             f"{max(rel, key=rel.get)} {max(rel.values())}")
    return out


def run_module(phase, tag, cmd) -> str:
    """Run `cmd` (a ``python -m`` of the port) from the repo root with the
    port on the path; raise on a non-zero exit; returns its stdout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    log(phase, f"{tag}: rc={r.returncode} in {time.perf_counter() - t0:.1f} s\n"
        f"{r.stdout.strip()}")
    if r.returncode != 0:
        raise AssertionError(f"{phase} {tag} failed:\n{r.stderr[-4000:]}")
    return r.stdout


def bit_equal_checkpoints(d, step, full) -> None:
    """The committed checkpoint `step` in `d` has `full`'s leaves, bit for bit."""
    _, _, resumed = load_checkpoint(d, step)
    if set(full) != set(resumed):
        raise AssertionError("resumed checkpoint has other leaves")
    differ = [p for p in full if full[p].tobytes() != resumed[p].tobytes()]
    if differ:
        raise AssertionError(f"resume is not bit-equal at {differ[:5]}")


def launcher_phase() -> dict:
    """``launch/train.py --reduced`` on the card in subprocesses: an
    uninterrupted 6-step run, then a run resumed from its step-3 checkpoint
    (the final one dropped) must end bit-equal."""
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--steps", "6",
               "--ckpt-every", "3", "--batch", "2", "--seq", "64", "--ckpt-dir", d]
        run = lambda tag: run_module("launcher", tag, cmd)  # noqa: E731
        run("uninterrupted")
        if committed_steps(d) != [3, 6]:
            raise AssertionError(f"checkpoints {committed_steps(d)}")
        _, _, full = load_checkpoint(d, 6)
        shutil.rmtree(Path(d) / "step_6")  # a crash after the step-3 checkpoint
        stdout = run("resumed")
        if "resumed from step 3" not in stdout:
            raise AssertionError("the second run did not resume from step 3")
        bit_equal_checkpoints(d, 6, full)
        out = {"leaves": len(full), "bit_equal": True, "final_step": int(full["['step']"])}
    log("launcher", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 13-14: DSBA gossip training (block_topk, flash at head_dim 256)
# ---------------------------------------------------------------------------

GOSSIP_LAYERS, GOSSIP_S, GOSSIP_STEPS = 2, 2048, 6
# dsba's constant step size here (the gossip example's 0.5 is for its tiny
# model): at 1e-3, 6 steps of gemma2-2b at full width stay finite
GOSSIP_LR = 1e-3


def gossip_setup():
    """(model config, TrainConfig, GossipConfig) of the gossip phase:
    gemma2-2b at full width cut to one local/global layer pair, 2 pods on a
    ring, dsba with block_topk compression through the kernel."""
    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=GOSSIP_LAYERS,
                              attention_kernel="on")
    gcfg = GossipConfig(n_pods=2, topology="ring", mode="dsba", compression="block_topk",
                        topk_ratio=0.01, block_size=4096, kernel_mode="on")
    return cfg, TrainConfig(optimizer=AdamConfig(lr=GOSSIP_LR)), gcfg


def expected_gossip_launches(cfg, gcfg) -> dict[str, int]:
    """Kernel launches of one gossip step: one block_topk a leaf (both pods
    in one call), per pod the flash forward twice a layer (forward and remat
    recompute) and the backward's two kernels once a layer."""
    want = dict.fromkeys(WRAPPERS, 0)
    per_pods = 2 * cfg.n_layers * gcfg.n_pods
    want.update(block_topk=len(tree_leaves(T.model_defs(cfg))), flash_attention=per_pods,
                flash_attention_bwd=per_pods)
    return want


GOSSIP_RANGES = ("gossip_grads", "gossip_update")


def top_by_prefix(times: dict[str, float], n: int, width: int = 90) -> dict[str, float]:
    """The `n` largest of {kernel name: us}, names cut to `width` characters
    and the times of names that then coincide summed."""
    out: dict[str, float] = {}
    for name, t in times.items():
        out[name[:width]] = out.get(name[:width], 0.0) + t
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:n])


def profile_ranges(fn):
    """One call of ``fn`` under torch.profiler: (device busy us, {kernel:
    (us, count)}, {range: (span us, busy us)}, {range: {kernel: us}}). The
    ranges are the gossip step's record_function halves; a range's span is
    its extent on the device timeline, its busy time the summed durations
    of the kernels that start inside it."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = {e.key: (e.device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == cuda and e.key not in GOSSIP_RANGES}
    events = [e for e in prof.events() if e.device_type == cuda]
    kernels = [e for e in events if e.name not in GOSSIP_RANGES]
    ranges, by_range = {}, {}
    for r in (e for e in events if e.name in GOSSIP_RANGES):
        lo, hi = r.time_range.start, r.time_range.end
        inside = [e for e in kernels if lo <= e.time_range.start < hi]
        ranges[r.name] = (hi - lo, sum(e.time_range.elapsed_us() for e in inside))
        per = by_range.setdefault(r.name, {})
        for e in inside:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    return sum(t for t, _ in kern.values()), kern, ranges, by_range


def gossip_phase(device, topk_rows: bool = False, host_params: bool = False
                 ) -> tuple[dict, dict, dict | None]:
    """GOSSIP_STEPS dsba steps of gemma2-2b at full width on 2 pods.

    Step 0 holds every block_topk (bit for bit), flash forward and flash
    backward call to its plain version; steps 1-4 are timed; step 5 is
    profiled. Every step: launches per kernel as predicted, finite loss,
    grad norm and consensus distance, wire bytes equal to the closed form.
    `topk_rows` (``--gossip-profile``) adds ``gossip_topk_rows``.
    Returns (summary, launches over every step, the final params copied to
    the host if `host_params`, else None)."""
    cfg, tc, gcfg = gossip_setup()
    full = get_config("gemma2-2b")
    n = tree_num_params(T.model_defs(cfg))
    n_full = tree_num_params(T.model_defs(full))
    copies = 2 * gcfg.n_pods + 6 * gcfg.n_pods  # params, mu, nu, prev, g_prev, 3 streams
    log("gossip", f"{cfg.name} cut {full.n_layers} -> {cfg.n_layers} layers: {n} params, "
        f"{4 * n / 1e9:.2f} GB a float32 copy ({4 * n_full / 1e9:.2f} GB at {full.n_layers}); "
        f"the state of {gcfg.n_pods} pods is {copies} copies, {copies * 4 * n / 1e9:.1f} GB "
        f"({copies * 4 * n_full / 1e9:.1f} GB at {full.n_layers} layers)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_gossip_state(cfg, tc, gcfg, 0, device)
    torch.cuda.synchronize()
    state_gb = sum(t.numel() * t.element_size() for t in tree_leaves(state)) / 1e9
    log("gossip", f"state {state_gb:.2f} GB drawn in {time.perf_counter() - t0:.2f} s")
    step_fn = make_gossip_train_step(None, cfg, tc, gcfg)
    ld = LoaderConfig(cfg.vocab_size, gcfg.n_pods * 1, GOSSIP_S, n_shards=gcfg.n_pods)
    shapes = [d.shape for d in tree_leaves(T.model_defs(cfg))]
    wire = wire_bytes_per_pod(shapes, gcfg)
    want = expected_gossip_launches(cfg, gcfg)
    total = dict.fromkeys(WRAPPERS, 0)
    rows, walls, per_step = [], [], []

    def one_step(i):
        nonlocal state
        before = launches()
        state, m = step_fn(state, gossip_batch(ld, gcfg.n_pods, GOSSIP_S, i))
        got = {k: c - before[k] for k, c in launches().items()}
        if got != want:
            raise AssertionError(f"gossip step {i}: launches {got} != {want}")
        for k, c in got.items():
            total[k] += c
        per_step.append(m)

    def record(i):
        m = per_step[i]
        row = {"step": i, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "consensus_distance": float(consensus_distance(state["params"])),
               "wire_bytes_per_pod": int(m["wire_bytes_per_pod"])}
        log("gossip", json.dumps(row))
        if not all(math.isfinite(row[k]) for k in ("loss", "grad_norm", "consensus_distance")):
            raise AssertionError(f"gossip step {i}: not finite {row}")
        if row["wire_bytes_per_pod"] != wire:
            raise AssertionError(f"gossip step {i}: wire bytes {row['wire_bytes_per_pod']} "
                                 f"!= the closed form {wire}")
        rows.append(row)

    reset_launches()
    t0 = time.perf_counter()
    with ops.held_to_plain("block_topk") as tk, ops.held_to_plain("flash_attention") as fwd, \
            ops.held_to_plain("flash_attention_bwd") as bwd:
        one_step(0)
    torch.cuda.synchronize()
    t_held = time.perf_counter() - t0
    record(0)
    held = (len(tk), len(fwd), len(bwd))
    if held != (want["block_topk"], want["flash_attention"], want["flash_attention_bwd"] // 2):
        raise AssertionError(f"step 0 held {held} block_topk, flash, flash_bwd calls")
    if not all(tk.exact):
        raise AssertionError(f"block_topk calls not bit-equal to the plain version: {tk.exact}")
    peak_step0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(1, GOSSIP_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        record(i)
    peak = torch.cuda.max_memory_allocated()
    busy_us, kern, ranges, by_range = profile_ranges(lambda: one_step(GOSSIP_STEPS - 1))
    record(GOSSIP_STEPS - 1)
    wall_ms = float(np.median(walls)) * 1e3
    busy_ms = busy_us / 1e3
    topk_us = sum(t for k, (t, _) in kern.items() if "block_topk_" in k)
    update_us = ranges["gossip_update"][1] if "gossip_update" in ranges else None
    top = top_by_prefix({k: t for k, (t, _) in kern.items()}, 10)
    top_update = top_by_prefix(by_range.get("gossip_update", {}), 8)
    summary = {
        "layers": cfg.n_layers, "pods": gcfg.n_pods, "B_per_pod": 1, "S": GOSSIP_S,
        "tokens_per_step": gcfg.n_pods * GOSSIP_S, "lr": GOSSIP_LR, "state_gb": state_gb,
        "steps": rows, "step0_s_held_to_plain": t_held,
        "step0_block_topk_vs_plain_max_abs": list(tk), "step0_block_topk_bit_equal": tk.exact,
        "step0_flash_fwd_vs_plain_max_abs": list(fwd), "step0_flash_fwd_rel_norm": fwd.rel,
        "step0_flash_bwd_vs_plain_max_abs": list(bwd), "step0_flash_bwd_rel_norm": bwd.rel,
        "step0_flash_bwd_plain_max_abs_grad": bwd.scale,
        "wire_bytes_per_pod_closed_form": wire,
        "dense_bytes_per_pod": 4 * n, "wire_share_of_dense": wire / (4 * n),
        "step_wall_ms": [w * 1e3 for w in walls], "step_wall_ms_median": wall_ms,
        "step_device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "tokens_per_s": gcfg.n_pods * GOSSIP_S / (wall_ms / 1e3),
        "port_kernel_launches_per_step": {k: c for k, c in want.items() if c},
        "kernel_launches_per_step_profiled": sum(c for _, c in kern.values()),
        "range_span_and_busy_ms": {k: [v / 1e3 for v in t] for k, t in ranges.items()},
        "block_topk_device_ms": topk_us / 1e3,
        # the update half's kernels without the selection: the exchange's
        # and the update's elementwise passes, index_add_ included
        "update_elementwise_device_ms": (update_us - topk_us) / 1e3 if update_us else None,
        "update_elementwise_share": (update_us - topk_us) / busy_us if update_us else None,
        "top_update_kernels_us": top_update,
        "peak_gb_steps_1_4": peak / 1e9, "peak_gb_step0_held": peak_step0 / 1e9,
        "top_kernels_us_per_step": top,
    }
    if topk_rows:
        summary["block_topk_rows"] = gossip_topk_rows(state, gcfg)
    log("gossip", json.dumps(summary))
    final = tree_map(lambda _, t: t.detach().cpu(), state["params"]) if host_params else None
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return summary, total, final


def gossip_topk_rows(state, gcfg) -> dict:
    """The rows the next gossip step's largest selection takes: the
    embedding leaf's residual 2 theta - theta_prev - theta_hat of both pods,
    in blocks. block_topk's time on them (held bit for bit to the plain
    version) beside the random rows' at the same shape, and what sets it:
    the share of rows whose first-digit boundary equals that of the row
    their CTA took before (those are split in one pass), and the share
    whose boundary bin overflows a warp's candidate list (those refine the
    whole row). A diagnosis (``--gossip-profile`` only): it mirrors the
    kernel's partition (4 warps' contiguous quarters, STAGED_CAP / 4
    candidates a warp, the first digit as key >> 23)."""
    p, pp, rec = max(zip(tree_leaves(state["params"]), tree_leaves(state["params_prev"]),
                         tree_leaves(state["recon"])), key=lambda t: t[0].numel())
    block = gcfg.block_size
    k = max(1, int(block * gcfg.topk_ratio))
    x = (2 * p - pp - rec[:, 0]).float().reshape(-1, block)
    nb = x.shape[0]
    plan = topk_plan(block, k, nb)
    w = plan["warps"]
    d0 = torch.empty(nb, dtype=torch.int32, device=x.device)
    over = 0
    for lo in range(0, nb, 16_384):
        key = magnitude_key(x[lo:lo + 16_384])
        d0[lo:lo + 16_384] = torch.topk(key, k, dim=1).values[:, -1] >> 23
        part = ((key >> 23) == d0[lo:lo + 16_384, None]).view(-1, w, block // w).sum(-1)
        over += int((part.max(1).values > plan["cap"] // w).sum())
        del key, part
    got, want = block_topk(x, k), block_topk_ref(x, k)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("block_topk on the gossip rows: not bit-equal")
    del got, want
    g = plan["grid"]
    out = {"shape": [nb, block, k], "ms": cuda_ms(lambda: block_topk(x, k), iters=10, warmup=2),
           "guess_hit_share": float((d0[g:] == d0[:-g]).float().mean()),
           "list_overflow_share": over / nb,
           "boundary_digits": torch.unique(d0, return_counts=True)[0].tolist()[:16]}
    log("gossip", f"block_topk on the embedding leaf's residual rows: {json.dumps(out)}")
    return out


def gossip_batch(ld, n_pods, s, i) -> dict:
    """Step i's batch of the gossip phases: (pods, 1, s) token arrays."""
    return {k: np.asarray(v).reshape(n_pods, 1, s) for k, v in batch_at(ld, i).items()}


def gossip_trajectory(device, setup, steps, keep_at, s=GOSSIP_S, host_params=False
                      ) -> tuple[list[dict], list]:
    """`steps` local steps of a gossip setup from seed 0: each step's loss,
    grad norm and consensus distance, and the params' ``pod_digests`` (or,
    with `host_params`, their host copies) after `keep_at` steps. With
    compression "none" the consensus distance is reported,
    not gated: the compressed run's growth comes from its cold CHOCO
    reconstructions, which start at zero while the params sit at a nonzero
    consensus (the reference's init, kept for parity), not from replicas
    drifting on their own data."""
    cfg, tc, gcfg = setup
    ld = LoaderConfig(cfg.vocab_size, gcfg.n_pods, s, n_shards=gcfg.n_pods)
    state = init_gossip_state(cfg, tc, gcfg, 0, device)
    step_fn = make_gossip_train_step(None, cfg, tc, gcfg)
    rows, kept = [], None
    for i in range(steps):
        state, m = step_fn(state, gossip_batch(ld, gcfg.n_pods, s, i))
        rows.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "consensus_distance": float(consensus_distance(state["params"]))})
        if i + 1 == keep_at:
            kept = (tree_map(lambda _, t: t.detach().cpu(), state["params"]) if host_params
                    else pod_digests(state))
    log("gossip", f"local, compression {gcfg.compression}: {json.dumps(rows)}")
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rows, kept


def gossip_launcher_phase() -> dict:
    """The gossip example on the card (tiny model, 4 pods, topk, a pod
    killed at step 5, checkpoints every 4 steps): the pods shrink to 3; a
    second run, from step 8's checkpoint after the final one is dropped,
    ends bit-equal."""
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.examples.train_lm_gossip", "--model", "tiny",
               "--pods", "4", "--compression", "topk", "--kill-pod-at", "5", "--steps", "12",
               "--ckpt-every", "4", "--ckpt-dir", d]
        out = run_module("gossip-example", "uninterrupted", cmd)
        if "[ft] pod killed at step 5: continuing with 3 pods" not in out:
            raise AssertionError("the example did not shrink to 3 pods")
        if committed_steps(d) != [4, 8, 12]:
            raise AssertionError(f"checkpoints {committed_steps(d)}")
        _, meta, full = load_checkpoint(d, 12)
        if meta != {"n_pods": 3} or full["['params']/['embed']"].shape[0] != 3:
            raise AssertionError(f"final checkpoint: {meta}")
        losses = [float(line.split()[3]) for line in out.splitlines()
                  if line.startswith("step")]
        if not losses or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"example losses {losses}")
        shutil.rmtree(Path(d) / "step_12")  # a crash after the step-8 checkpoint
        out = run_module("gossip-example", "resumed", cmd)
        if "resumed from step 8" not in out or "pods=3" not in out:
            raise AssertionError("the second run did not resume from step 8 with 3 pods")
        bit_equal_checkpoints(d, 12, full)
        summary = {"leaves": len(full), "bit_equal": True, "pods_after_kill": 3,
                   "losses": losses}
    log("gossip-example", json.dumps(summary))
    return summary

# ---------------------------------------------------------------------------
# phases 15-18: the ssm family (mamba2-1.3b; ssd_chunk forward and backward)
# ---------------------------------------------------------------------------

# (B, nc, Q, nh, hd, ds) of the ssd calls on the main paths: the score phase
# (B=1, S=2048), the train step (B=4, S=2048) and a serve prefill (S=256)
SSD_MAIN = {"score": (1, 8, 256, 64, 64, 128), "train": (4, 8, 256, 64, 64, 128),
            "prefill": (1, 1, 256, 64, 64, 128)}
# ragged: Q of 1, 5 and 37, nh of 3 and 6; the reduced models' widths
SSD_RAGGED = [(1, 1, 1, 3, 64, 128), (2, 1, 5, 6, 64, 128), (1, 2, 37, 3, 64, 128),
              (1, 3, 37, 6, 16, 16)]
# inputs at the model's scale: xdt, B and C are conv + silu outputs (std ~0.5
# at init); at unit scale and Q = 256 even the float32 plain version misses
# the 2e-5 bar against float64 on some elements (reported, not gated)
SSD_SCALE = 0.5
SSD_BAR = ops.get_kernel("ssd_chunk").tolerance(torch.float32)
SSD_GRAD_BAR = ops.get_kernel("ssd_chunk_bwd").tolerance(torch.float32)
SSM_TRAIN_B, SSM_TRAIN_S, SSM_TRAIN_STEPS = 4, 2048, 5


def ssd_inputs(shape, device, seed=0, scale=SSD_SCALE, decay=(0.01, 0.2)):
    """Seeded ((xdt, cum, Bc, Cc), (dy, dst)) float32 on `device`; cum is
    the inclusive cumsum of -uniform(decay) log-decays within each chunk."""
    B, nc, Q, nh, hd, ds = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*size):
        return torch.randn(*size, generator=g, device=device) * scale

    lo, hi = decay
    cum = -torch.cumsum(torch.rand(B, nc, Q, nh, generator=g, device=device) * (hi - lo) + lo,
                        dim=2)
    return ((rnd(B, nc, Q, nh, hd), cum.contiguous(), rnd(B, nc, Q, ds), rnd(B, nc, Q, ds)),
            (rnd(B, nc, Q, nh, hd), rnd(B, nc, nh, ds, hd)))


def _bar_ratio(got, want, tol) -> float:
    """The largest |got - want| / (atol + rtol |want|): 1.0 is the bar."""
    w = want.double()
    return float(((got.double() - w).abs() / (tol.atol + tol.rtol * w.abs())).max())


def _outside_bar(got, want, tol) -> int:
    """Elements of got farther from want than atol + rtol |want|."""
    w = want.double()
    return int(((got.double() - w).abs() > tol.atol + tol.rtol * w.abs()).sum())


def ssd_parity(device) -> dict[str, float]:
    """ssd_chunk forward and backward against their plain versions in
    float64 on the same float32 inputs (the registry does the upcast), at
    the main paths' shapes, ragged shapes and under fast decay (a_log in
    [-8, -6]: every output and gradient finite); the relative Frobenius
    errors are logged. Returns the train shape's max abs errors."""
    worst = {}
    cases = [(name, shape, (0.01, 0.2)) for name, shape in SSD_MAIN.items()]
    cases += [(f"ragged {shape}", shape, (0.01, 0.5)) for shape in SSD_RAGGED]
    cases.append(("fast decay", (1, 2, 256, 64, 64, 128), (6.0, 8.0)))
    for i, (name, shape, decay) in enumerate(cases):
        args, cts = ssd_inputs(shape, device, seed=40 + i, decay=decay)
        e_f = ops.parity_check("ssd_chunk", *args, mode="on")
        e_b = ops.parity_check("ssd_chunk_bwd", *args, *cts, mode="on")
        out = ssd_chunk_fwd(*args) + ssd_chunk_bwd(*args, *cts)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in out):
            raise AssertionError(f"ssd {name}: non-finite outputs or gradients")
        with torch.no_grad():
            want = (ssd_chunk_ref(*(a.double() for a in args))
                    + ssd_chunk_bwd_ref(*(a.double() for a in args + cts)))
        rel = [ops.rel_err(g, w) for g, w in zip(out, want)]
        ratio = [_bar_ratio(g, w, SSD_BAR if k < 2 else SSD_GRAD_BAR)
                 for k, (g, w) in enumerate(zip(out, want))]
        del want
        log("ssd", f"{name} {shape}: forward max_abs_err={e_f!r} backward max_abs_err={e_b!r} "
            f"rel_norm (y, states, dxdt, dcum, dB, dC)={rel} worst |err| / (atol + rtol |want|) "
            f"{ratio}")
        if name == "train":
            worst = {"ssd_chunk": e_f, "ssd_chunk_bwd": e_b}
    # unit-scale inputs at the train shape (reported): the kernel and the
    # float32 plain version against float64, elements outside the bars
    args, cts = ssd_inputs(SSD_MAIN["train"], device, seed=7, scale=1.0)
    with torch.no_grad():
        want = ssd_chunk_ref(*(a.double() for a in args))
        got, plain32 = ssd_chunk_fwd(*args), ssd_chunk_ref(*args)
        unit = {"kernel_outside_bar": [_outside_bar(g, w, SSD_BAR) for g, w in zip(got, want)],
                "plain_f32_outside_bar": [_outside_bar(g, w, SSD_BAR)
                                          for g, w in zip(plain32, want)],
                "kernel_max_abs_err": [(g.double() - w).abs().max().item()
                                       for g, w in zip(got, want)],
                "plain_f32_max_abs_err": [(g.double() - w).abs().max().item()
                                          for g, w in zip(plain32, want)],
                "kernel_equals_plain_f32_bitwise": [torch.equal(g, p)
                                                    for g, p in zip(got, plain32)],
                "elements": [w.numel() for w in want]}
    del want, got, plain32
    log("ssd", f"unit-scale inputs at the train shape, forward (reported): {json.dumps(unit)}")
    return worst


def ssd_bounds(shape) -> dict[str, dict]:
    """The least time (ms) the card could take for one forward and one
    backward call at `shape`. Operations counted for the causal pairs
    i >= j that the function needs: the scores (2 ds a pair), per head
    2 hd a pair for y (forward) and for dM and dxdt (backward), 2 Q ds hd
    for the chunk state (forward) and for each of its two gradient terms
    (backward), and dscores -> dB, dC (4 ds a pair). Bytes: each input read
    once, each output written once. Two rates for these float32 products:
    the CUDA cores' float32 peak (``bound_fp32_ms``), and three TF32
    tensor-core products a product at the TF32 peak, the split the kernels
    use (``bound_ms``, the lesser: the least time for float32-accurate
    products on this card)."""
    B, nc, Q, nh, hd, ds = shape
    meta = lambda *size: torch.empty(size, device="meta")  # noqa: E731
    x, bc = meta(B, nc, Q, nh, hd), meta(B, nc, Q, ds)
    args = (x, meta(B, nc, Q, nh), bc, bc)
    out = {}
    for name, call in (("ssd_chunk", args), ("ssd_chunk_bwd", (*args, x, meta(B, nc, nh, ds, hd)))):
        nops, _ = ops.get_kernel(name).cost(*call)  # KernelSpec.cost, as the dry run counts
        fp32 = kernel_bound(name, *call, dtype=torch.float32)
        tf32 = kernel_bound(name, *call, dtype=TF32, products=3)
        out[name] = {"bound_ms": tf32[0], "bound_by": tf32[1], "bound_fp32_ms": fp32[0],
                     "gflop": nops / 1e9, "bound_counts": "3 TF32 products a float32 product"}
    return out


def time_ssd(device, shapes=SSD_MAIN) -> dict[str, dict]:
    """Both SSD kernels at each main-path shape (train, score, serve
    prefill; mamba2's, or the ones given): CUDA events, profiler device
    time, the plain version (float32, on the card) and the bounds. The
    kernels line carries the train shape's numbers, and every shape's under
    ``shapes``. No single PyTorch call computes them: library "none"."""
    fwd_names = ("ssd_fwd_kernel",)
    bwd_names = ("ssd_bwd_rows_kernel", "ssd_bwd_cols_kernel", "ssd_bwd_finish_kernel")
    out = {"ssd_chunk": {"shapes": {}}, "ssd_chunk_bwd": {"shapes": {}}}
    for label in ("train", "score", "prefill"):
        shape = shapes[label]
        args, cts = ssd_inputs(shape, device)
        bounds = ssd_bounds(shape)
        fwd = lambda: ssd_chunk_fwd(*args)  # noqa: E731
        bwd = lambda: ssd_chunk_bwd(*args, *cts)  # noqa: E731
        few = 1 if label == "train" else 3
        got = {
            "ssd_chunk": {
                "ms": cuda_ms(fwd, iters=20 if label == "train" else 100, warmup=3),
                "device_ms": kernel_device_ms(fwd, fwd_names, iters=5),
                "plain_ms": cuda_ms(lambda: ssd_chunk_ref(*args), iters=5 * few, warmup=1),
                **bounds["ssd_chunk"], "library_ms": None},
            "ssd_chunk_bwd": {
                "ms": cuda_ms(bwd, iters=10 if label == "train" else 50, warmup=2),
                "device_ms": kernel_device_ms(bwd, bwd_names, iters=5),
                "device_ms_by_kernel": {n: kernel_device_ms(bwd, (n,), iters=5)
                                        for n in bwd_names},
                "plain_ms": cuda_ms(lambda: ssd_chunk_bwd_ref(*args, *cts), iters=3 * few,
                                    warmup=1),
                **bounds["ssd_chunk_bwd"], "library_ms": None},
        }
        for name, r in got.items():
            out[name]["shapes"][label] = {"shape": list(shape), **r}
            if label == "train":
                out[name].update(r)
        log("ssd", f"{label} shape {shape}: {json.dumps(got)}")
        del args, cts
    return out


def ssm_config():
    """mamba2-1.3b at full width and depth (48 layers, d 2048, d_inner 4096,
    64 heads of 64, state 128, vocab 50,280), kernels on."""
    return dataclasses.replace(get_config("mamba2-1.3b"), ssm_kernel="on")


def ssm_serve_phase(device, cfg, params) -> tuple[dict, dict]:
    """The Scheduler at full width and depth with mamba2-1.3b's random init.

    Hard checks: every request ends with its token count; no page is ever
    allocated; the state pool is never reallocated; ssd_chunk launches =
    prefills x 48 and none in decode; every ssd call of the first step's
    prefills held to the plain version; the slot state of a padded prefill
    equals a prefill of exactly valid_len tokens (float32 compute: the f32
    bar, every layer); request 0's first decode-step logits, paged against
    the contiguous ``generate``, within the bf16 bar in relative norm.
    Returns (summary, launches)."""
    sch = Scheduler(cfg, params, SERVE_POOL, device=device)
    ptrs = sch.pool.data_ptrs()
    reqs = serve_requests(cfg)
    for r in reqs:
        sch.submit(r)
    inner = sch.decode_fn
    decode_ssd, pages, first, busiest = [], [], {}, {}

    def decode_fn(params_, tokens, pools, table, lengths):
        if not decode_ssd:  # request 0's slot state right after its padded prefill
            slot = next(sl for sl, st in sch.active.items() if st.req.rid == 0)
            first["state"] = pools["state"][:, slot].clone()
        before = ssd_chunk_fwd.launches
        out = inner(params_, tokens, pools, table, lengths)
        decode_ssd.append(ssd_chunk_fwd.launches - before)
        pages.append(sch.pool.used_page_count)
        live = len(sch.active)
        if live > busiest.get("live", -1):
            busiest.update(live=live, tokens=tokens.clone(), table=table.clone(),
                           lengths=lengths.clone())
        for slot, st in sch.active.items():
            if st.req.rid == 0 and len(st.generated) == 1:
                first["logits"] = out[1][slot].float().clone()
        return out

    sch.decode_fn = decode_fn
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ops.held_to_plain("ssd_chunk") as held:
        sch.step()  # admits the first max_batch requests
    held_prefills = sch.stats.steps[0].admitted
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results, stats = sch.run()
    torch.cuda.synchronize()
    wall, wall_unheld = time.perf_counter() - t0, time.perf_counter() - t1
    got = launches()
    prefills = sum(st.admitted for st in stats.steps)
    want = {**dict.fromkeys(WRAPPERS, 0), "ssd_chunk": prefills * cfg.n_layers}
    if got != want or any(decode_ssd):
        raise AssertionError(f"ssm serve launches {got} != {want} (decode {set(decode_ssd)})")
    if len(held) != held_prefills * cfg.n_layers or held_prefills == 0:
        raise AssertionError(f"{len(held)} ssd calls held for {held_prefills} prefills")
    for r in reqs:
        toks = results[r.rid]
        if toks.shape != (r.max_new_tokens,) or not np.all((0 <= toks) & (toks < cfg.vocab_size)):
            raise AssertionError(f"ssm request {r.rid}: tokens {toks.shape}")
    if max(pages) != 0 or stats.peak_occupancy != 0.0 or sch.pool.used_page_count != 0:
        raise AssertionError(f"ssm serve allocated pages: {max(pages)}")
    if sch.pool.data_ptrs() != ptrs:
        raise AssertionError("the ssm state pool was reallocated")

    r0 = reqs[0]
    plen = len(r0.tokens)
    prompt = torch.as_tensor(r0.tokens, device=device)[None]
    padded = torch.zeros((1, SERVE_POOL.prompt_pad), dtype=torch.long, device=device)
    padded[0, :plen] = prompt[0]
    # the padded prefill's state against a prefill of exactly plen tokens:
    # float32 compute (the f32 bar, every layer), and the served bf16 one
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    vl = torch.tensor([plen], dtype=torch.int32, device=device)
    c_pad, _ = T.prefill(cfg32, params, padded, T.init_cache(cfg32, 1, 256, device),
                         valid_len=vl)
    c_ex, _ = T.prefill(cfg32, params, prompt, T.init_cache(cfg32, 1, plen, device))
    state_f32 = {k: [ops.assert_close(c_pad[k][i], c_ex[k][i], SSD_BAR)
                     for i in range(cfg.n_layers)] for k in ("state", "conv")}
    del c_pad
    c_bf, _ = T.prefill(cfg, params, prompt, T.init_cache(cfg, 1, plen, device))
    pooled_rel = [ops.rel_err(first["state"][i], c_bf["state"][i, 0])
                  for i in range(cfg.n_layers)]
    del c_bf, c_ex
    gen = generate(cfg, params, prompt, max_new_tokens=1)
    paged_rel = ops.rel_err(first["logits"], gen.logits[1][0])
    if paged_rel > BF16_BAR:  # whole-model bf16 logits: the bar in relative norm
        raise AssertionError(f"request 0: paged vs contiguous logits, relative {paged_rel}")

    # a decode step at the busiest state, replayed (the run is over: its
    # state writes land in finished slots)
    args = (params, busiest["tokens"], sch.pool.pools, busiest["table"], busiest["lengths"])
    step = replay_step(lambda: T.decode_step_paged(cfg, *args))
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)
                       if t.dtype == cfg.compute_dtype)
    state_bytes = sum(t.numel() * t.element_size() for t in sch.pool.pools.values())
    n_tokens = int(sum(len(v) for v in results.values()))
    summary = {
        "requests": len(reqs), "tokens": n_tokens, "prefills": prefills,
        "decode_steps": stats.decode_steps, "preemptions": stats.preemptions,
        "peak_active": stats.peak_active, "pages_allocated_max": max(pages),
        "state_pool_gb": state_bytes / 1e9,
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "decode_ms_per_step_incl_admission": wall * 1e3 / stats.decode_steps,
        # after the held first step (its plain float64 checks are not serving)
        "wall_s_after_step0": wall_unheld,
        "tokens_per_s_after_step0": (n_tokens - stats.steps[0].tokens_generated
                                     - held_prefills) / wall_unheld,
        "held_prefills": held_prefills, "ssd_vs_plain_max_abs": max(held),
        "ssd_vs_plain_rel_norm_max": max(held.rel),
        "padded_vs_exact_f32_state_max_abs": max(state_f32["state"]),
        "padded_vs_exact_f32_conv_max_abs": max(state_f32["conv"]),
        "reported_pooled_vs_exact_bf16_state_rel_per_layer": pooled_rel,
        "paged_vs_contiguous_logits_rel": paged_rel,
        "paged_vs_contiguous_logits_max_abs": (first["logits"] - gen.logits[1][0]).abs().max().item(),
        "reported_paged_vs_contiguous_same_first_token": int(gen.tokens[0, 0]) == int(results[0][0]),
        "busiest_live_slots": busiest["live"], "decode_step": step,
        "weight_bytes_read_per_step": weight_bytes,
        "decode_step_bound_ms": (weight_bytes + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3,
    }
    log("ssm-serve", json.dumps(summary))
    return summary, got


def ssm_score_phase(device, cfg, params, s=2048) -> tuple[dict, dict]:
    """forward() at full width and depth, B=1, S=2048: 48 ssd_chunk
    launches, each held to the plain version on its own inputs; finite
    logits; ssm_kernel "on" vs "off" logits within 2e-2 in relative norm."""
    tokens = score_tokens(cfg, device, s)
    cfg_off = dataclasses.replace(cfg, ssm_kernel="off")
    T.forward(cfg, params, tokens[:, :256])  # warm-up (cuBLAS plans)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on = T.forward(cfg, params, tokens)
    torch.cuda.synchronize()
    t_on = time.perf_counter() - t0
    got = launches()
    if got != {**dict.fromkeys(WRAPPERS, 0), "ssd_chunk": cfg.n_layers}:
        raise AssertionError(f"ssm score launches {got}: want {cfg.n_layers} ssd_chunk")
    if on.shape != (1, s, cfg.vocab_size) or not torch.isfinite(on).all():
        raise AssertionError(f"ssm score logits {tuple(on.shape)} not finite")
    with ops.held_to_plain("ssd_chunk") as held:
        T.forward(cfg, params, tokens)
    if len(held) != cfg.n_layers:
        raise AssertionError(f"{len(held)} ssd calls held to the plain version")
    t0 = time.perf_counter()
    off = T.forward(cfg_off, params, tokens)
    torch.cuda.synchronize()
    t_off = time.perf_counter() - t0
    rel = ops.rel_err(on, off)
    out = {"B": 1, "S": s, "seconds_on": t_on, "seconds_off": t_off,
           "tokens_per_s_on": s / t_on, "ssd_vs_plain_per_layer_max_abs": list(held),
           "ssd_vs_plain_per_layer_rel_norm": held.rel,
           "on_vs_off_logits_rel_norm": rel,
           "on_vs_off_logits_max_abs": (on - off).abs().max().item(),
           "on_vs_off_logits_bitwise_equal": torch.equal(on, off),
           "logits_abs_max": off.abs().max().item()}
    log("ssm-score", json.dumps(out))
    if rel > BF16_BAR:
        raise AssertionError(f"ssm score on vs off: relative {rel}")
    return out, got


def ssm_train_setup():
    """(cfg, TrainConfig, LoaderConfig) of the ssm train phase: mamba2-1.3b
    at full width and depth, remat "full", AdamW at the launcher's defaults,
    B=4 and S=2048 from batch_at."""
    cfg = ssm_config()
    return (cfg, TrainConfig(optimizer=AdamConfig()),
            LoaderConfig(cfg.vocab_size, SSM_TRAIN_B, SSM_TRAIN_S, seed=0))


def expected_ssm_train_launches(cfg) -> dict[str, int]:
    """One ssm train step with remat 'full': the forward kernel twice a
    layer (forward, recompute), the backward's three kernels once a layer."""
    return {**dict.fromkeys(WRAPPERS, 0), "ssd_chunk": 2 * cfg.n_layers,
            "ssd_chunk_bwd": 3 * cfg.n_layers}


def ssm_train_phase(device) -> tuple[dict, dict]:
    """SSM_TRAIN_STEPS steps of mamba2-1.3b at full width and depth.

    Step 0 holds every ssd forward and backward call to the plain version
    (float32 bars; gradients also in relative norm, their size logged);
    steps 1-4 are timed (wall, peak memory) with launches asserted each
    step; the device time is profiled in a fresh process (``ssm_profile``).
    Then one local_grads "on" against "off". Returns (summary, launches
    over every step)."""
    cfg, tc, ld = ssm_train_setup()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, tc, 0, device)
    torch.cuda.synchronize()
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves({"p": state["params"], "o": state["opt"]})) / 1e9
    log("ssm-train", f"{cfg.name} x{cfg.n_layers} layers, {cfg.param_count()} params "
        f"({tree_num_params(T.model_defs(cfg))} in the tree), train state (params, mu, nu) "
        f"{state_gb:.2f} GB, drawn in {time.perf_counter() - t0:.1f} s")
    want = expected_ssm_train_launches(cfg)
    total = dict.fromkeys(WRAPPERS, 0)
    losses, gnorms, walls = [], [], []

    def one_step(i):
        nonlocal state
        before = launches()
        state, m = train_step(cfg, tc, state, batch_at(ld, i))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        got = {n: c - before[n] for n, c in launches().items()}
        if got != want:
            raise AssertionError(f"ssm train step {i}: launches {got} != {want}")
        for n, c in got.items():
            total[n] += c

    reset_launches()
    t0 = time.perf_counter()
    with ops.held_to_plain("ssd_chunk") as fwd, ops.held_to_plain("ssd_chunk_bwd") as bwd:
        one_step(0)
    torch.cuda.synchronize()
    t_held = time.perf_counter() - t0
    if len(fwd) != 2 * cfg.n_layers or len(bwd) != cfg.n_layers:
        raise AssertionError(f"step 0 held {len(fwd)} forward and {len(bwd)} backward calls")
    peak_step0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(1, SSM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"ssm train losses {losses} grad norms {gnorms}")
    wall_ms = float(np.median(walls)) * 1e3
    summary = {
        "layers": cfg.n_layers, "B": SSM_TRAIN_B, "S": SSM_TRAIN_S,
        "tokens_per_step": SSM_TRAIN_B * SSM_TRAIN_S, "train_state_gb": state_gb,
        "losses": losses, "grad_norms": gnorms, "step0_s_held_to_plain": t_held,
        "step0_ssd_fwd_vs_plain_max_abs": max(fwd), "step0_ssd_fwd_rel_norm_max": max(fwd.rel),
        "step0_ssd_bwd_vs_plain_max_abs": list(bwd), "step0_ssd_bwd_rel_norm": bwd.rel,
        "step0_ssd_bwd_plain_max_abs_grad": bwd.scale,
        "step_wall_ms": [w * 1e3 for w in walls], "step_wall_ms_median": wall_ms,
        "tokens_per_s": SSM_TRAIN_B * SSM_TRAIN_S / (wall_ms / 1e3),
        "port_kernel_launches_per_step": {k: c for k, c in want.items() if c},
        "peak_gb_steps_1_4": peak / 1e9, "peak_gb_step0_held": peak_step0 / 1e9,
    }
    log("ssm-train", json.dumps(summary))

    # one local_grads, ssm_kernel "on" against "off", on the trained params
    del state["opt"]
    gc.collect()
    torch.cuda.empty_cache()
    batch = batch_at(ld, 0)
    l_on, g_on = local_grads(cfg, tc, state["params"], batch)
    l_off, g_off = local_grads(dataclasses.replace(cfg, ssm_kernel="off"), tc, state["params"],
                               batch)
    loss_rel = abs(float(l_on) - float(l_off)) / abs(float(l_off))
    rel = tree_map(lambda _, a, b: ops.rel_err(a, b), g_on, g_off)  # laid out as the params
    worst = max(tree_leaves(rel))
    on_off = {"loss_on": float(l_on), "loss_off": float(l_off), "loss_rel": loss_rel,
              "grad_rel_norm_max": worst, "grad_rel_norm": rel}
    log("ssm-train", f"on vs off: {json.dumps(on_off)}")
    if loss_rel > 1e-3 or worst > GRAD_BAR:
        raise AssertionError(f"ssm train on vs off: loss {loss_rel}, gradients {rel}")
    summary["on_vs_off"] = {k: v for k, v in on_off.items() if k != "grad_rel_norm"}
    del state, g_on, g_off
    gc.collect()
    torch.cuda.empty_cache()
    return summary, total


def ssm_profile(device) -> dict:
    """Run in a fresh process (``chip_smoke.py --ssm-profile``; late in the
    main process torch.profiler has dropped kernel events): the SSD kernels'
    times at the train shape, then the ssm train step: 2 steps warm, 2 timed
    without the profiler, 1 profiled (device busy, idle share, launches,
    top kernels)."""
    times = time_ssd(device)
    cfg, tc, ld = ssm_train_setup()
    state = init_train_state(cfg, tc, 0, device)

    def one(i):
        nonlocal state
        state, _ = train_step(cfg, tc, state, batch_at(ld, i))

    for i in range(2):
        one(i)
    walls = []
    for i in range(2, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    busy_us, kern = device_profile(lambda: one(4), 1)
    wall_ms = float(np.median(walls)) * 1e3
    names = ("ssd_fwd_kernel", "ssd_bwd_rows_kernel", "ssd_bwd_cols_kernel",
             "ssd_bwd_finish_kernel")
    ssd_us = {n: sum(t for k, (t, _) in kern.items() if n in k) for n in names}
    ssd_n = {n: sum(c for k, (_, c) in kern.items() if n in k) for n in names}
    train = {"step_wall_ms": [w * 1e3 for w in walls], "step_wall_ms_median": wall_ms,
             "step_device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
             "kernel_launches_per_step_profiled": sum(c for _, c in kern.values()),
             "profiled_ssd_launches": ssd_n,
             "ssd_device_ms": {k: v / 1e3 for k, v in ssd_us.items()},
             "top_kernels_us_per_step": top_by_prefix({k: t for k, (t, _) in kern.items()}, 10)}
    return {"ssd": times, "train": train}


def ssm_profile_subprocess() -> dict:
    """``ssm_profile`` in a fresh process on the same card; its JSON result."""
    res = profile_subprocess("--ssm-profile")
    n = ssm_config().n_layers
    want = {"ssd_fwd_kernel": 2 * n, "ssd_bwd_rows_kernel": n, "ssd_bwd_cols_kernel": n,
            "ssd_bwd_finish_kernel": n}
    if res["train"]["profiled_ssd_launches"] != want:  # the device times would be short
        log("ssm-profile", f"the profile recorded {res['train']['profiled_ssd_launches']} ssd "
            f"kernel events, the step launched {want}")
    return res


# ---------------------------------------------------------------------------
# phase 19: the hybrid family (zamba2-1.2b), in a fresh process (--hybrid)
# ---------------------------------------------------------------------------

HYBRID_TRAIN_B, HYBRID_TRAIN_S, HYBRID_TRAIN_STEPS = 4, 2048, 5
# the reference's long_500k (src/repro/launch/shapes.py): one sequence
# decoding from a 524,288-token cache; LONG_STEPS decode steps, the last of
# which attends over the whole cache
LONG_500K, LONG_STEPS = 524_288, 3
# the hybrid's ssd calls (B, nc, Q, nh, hd, ds): mamba2's, at state 64
SSD_HYBRID = {name: (*shape[:5], 64) for name, shape in SSD_MAIN.items()}


def hybrid_config():
    """zamba2-1.2b at full width and depth (38 ssm layers, d 2048, 64 heads
    of 64, state 64; one shared block, 32/32 heads of 64 and d_ff 8192,
    after every 6th layer; vocab 32,000), every kernel route "on"."""
    return dataclasses.replace(get_config("zamba2-1.2b"), attention_kernel="on",
                               ssm_kernel="on", decode_kernel="on")


def n_shared(cfg) -> int:
    """Uses of the shared block a pass: n_layers // hybrid_period (6)."""
    return cfg.n_layers // cfg.hybrid_period


def hybrid_serve_phase(device, cfg, params) -> tuple[dict, dict, tuple]:
    """The Scheduler at full width and depth with zamba2-1.2b's random init,
    the serve phase's pool and 12 requests.

    Hard checks: every request ends with its token count; decode_attention
    launches = decode steps x 6 (one a use of the shared block), ssd_chunk
    = prefills x 38, no flash launch (prefill passes a cache); the pools
    never reallocated; every decode_attention call of the first 4 decode
    steps (D = 64, group 1) and every ssd call of the first step's prefills
    held to the plain version. Reported: tokens/s, a replayed decode step,
    and request 0's first decode-step logits paged vs the contiguous
    ``generate`` (the shared attention has the reference's init, chaotic as
    minitron-8b's: ``condition_attention``). Returns (summary, launches, a
    decode snapshot (q, k_pool, v_pool, table, lengths) of the shared
    block's first use at the busiest step)."""
    n_attn = n_shared(cfg)
    sch = Scheduler(cfg, params, SERVE_POOL, device=device)
    ptrs = sch.pool.data_ptrs()
    reqs = serve_requests(cfg)
    for r in reqs:
        sch.submit(r)
    inner = sch.decode_fn
    held, first, busiest = [], {}, {}

    def decode_fn(params_, tokens, pools, table, lengths):
        if len(held) < 4:
            with ops.held_to_plain("decode_attention") as errs:
                out = inner(params_, tokens, pools, table, lengths)
            held.append(errs)
        else:
            out = inner(params_, tokens, pools, table, lengths)
        live = int(lengths.sum())
        if live > busiest.get("live", -1):
            busiest.update(live=live, tokens=tokens.clone(), table=table.clone(),
                           lengths=lengths.clone())
        for slot, st in sch.active.items():
            if st.req.rid == 0 and len(st.generated) == 1:
                first["logits"] = out[1][slot].float().clone()
        return out

    sch.decode_fn = decode_fn
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ops.held_to_plain("ssd_chunk") as held_ssd:
        sch.step()  # admits the first max_batch requests
    held_prefills = sch.stats.steps[0].admitted
    results, stats = sch.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launches()
    prefills = sum(st.admitted for st in stats.steps)
    want = {**dict.fromkeys(WRAPPERS, 0), "ssd_chunk": prefills * cfg.n_layers,
            "decode_attention": stats.decode_steps * n_attn}
    if got != want or stats.decode_steps == 0:
        raise AssertionError(f"hybrid serve launches {got} != {want}")
    if [len(e) for e in held] != [n_attn] * 4:
        raise AssertionError(f"held decode calls a step: {[len(e) for e in held]}")
    if len(held_ssd) != held_prefills * cfg.n_layers or held_prefills == 0:
        raise AssertionError(f"{len(held_ssd)} ssd calls held for {held_prefills} prefills")
    for r in reqs:
        toks = results[r.rid]
        if toks.shape != (r.max_new_tokens,) or not np.all((0 <= toks) & (toks < cfg.vocab_size)):
            raise AssertionError(f"hybrid request {r.rid}: tokens {toks.shape}")
    if sch.pool.data_ptrs() != ptrs:
        raise AssertionError("the hybrid pools were reallocated")
    gen = generate(cfg, params, torch.as_tensor(reqs[0].tokens, device=device)[None],
                   max_new_tokens=1)
    args = (params, busiest["tokens"], sch.pool.pools, busiest["table"], busiest["lengths"])
    step = replay_step(lambda: T.decode_step_paged(cfg, *args))
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)
                       if t.dtype == cfg.compute_dtype)
    state_bytes = sum(t.numel() * t.element_size() for t in sch.pool.pools["ssm"].values())
    kv_bytes = 2 * busiest["live"] * n_attn * cfg.kv_dim * 2
    n_tokens = int(sum(len(v) for v in results.values()))
    summary = {
        "requests": len(reqs), "tokens": n_tokens, "prefills": prefills,
        "decode_steps": stats.decode_steps, "preemptions": stats.preemptions,
        "peak_active": stats.peak_active, "peak_occupancy": stats.peak_occupancy,
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "decode_ms_per_step_incl_admission": wall * 1e3 / stats.decode_steps,
        "decode_vs_plain_max_abs_per_step": [max(e) for e in held],
        "decode_vs_plain_rel_norm_max": max(r for e in held for r in e.rel),
        "held_prefills": held_prefills, "ssd_vs_plain_max_abs": max(held_ssd),
        "ssd_vs_plain_rel_norm_max": max(held_ssd.rel),
        "reported_paged_vs_contiguous_logits_rel": ops.rel_err(first["logits"], gen.logits[1][0]),
        "reported_paged_vs_contiguous_same_first_token":
            int(gen.tokens[0, 0]) == int(results[0][0]),
        "busiest_live_tokens": busiest["live"],
        "decode_step": step, "weight_bytes_read_per_step": weight_bytes,
        "decode_step_bound_ms": (weight_bytes + 2 * state_bytes + kv_bytes)
        / HBM_BYTES_PER_S * 1e3,
    }
    log("hybrid-serve", json.dumps(summary))
    gen_q = torch.Generator(device=device).manual_seed(1)
    snap = (torch.randn(SERVE_POOL.max_batch, cfg.n_heads, cfg.head_dim, device=device,
                        generator=gen_q).to(cfg.compute_dtype),
            sch.pool.pools["attn"]["k"][0], sch.pool.pools["attn"]["v"][0],
            busiest["table"], busiest["lengths"] + 1)
    return summary, got, snap


def hybrid_score_phase(device, cfg, params, s=2048) -> tuple[dict, dict]:
    """forward() at full width and depth, B=1, S=2048: 6 flash_attention
    launches (D = 64, 32/32 heads, causal) and 38 ssd_chunk launches (state
    64), each held to the plain version on its own inputs; finite logits.
    The on vs off logit difference is reported (chaotic at this init)."""
    tokens = score_tokens(cfg, device, s)
    T.forward(cfg, params, tokens[:, :256])  # warm-up (cuBLAS plans)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on = T.forward(cfg, params, tokens)
    torch.cuda.synchronize()
    t_on = time.perf_counter() - t0
    got = launches()
    want = {**dict.fromkeys(WRAPPERS, 0), "flash_attention": n_shared(cfg),
            "ssd_chunk": cfg.n_layers}
    if got != want:
        raise AssertionError(f"hybrid score launches {got} != {want}")
    if on.shape != (1, s, cfg.vocab_size) or not torch.isfinite(on).all():
        raise AssertionError(f"hybrid score logits {tuple(on.shape)} not finite")
    with ops.held_to_plain("flash_attention") as flash, ops.held_to_plain("ssd_chunk") as ssd:
        T.forward(cfg, params, tokens)
    if len(flash) != n_shared(cfg) or len(ssd) != cfg.n_layers:
        raise AssertionError(f"{len(flash)} flash and {len(ssd)} ssd calls held")
    off = T.forward(dataclasses.replace(cfg, attention_kernel="off", ssm_kernel="off"), params,
                    tokens)
    out = {"B": 1, "S": s, "seconds_on": t_on, "tokens_per_s_on": s / t_on,
           "flash_vs_plain_max_abs": list(flash), "flash_vs_plain_rel_norm": flash.rel,
           "ssd_vs_plain_max_abs": max(ssd), "ssd_vs_plain_rel_norm_max": max(ssd.rel),
           "reported_on_vs_off_logits_rel_norm": ops.rel_err(on, off),
           "logits_abs_max": off.abs().max().item()}
    log("hybrid-score", json.dumps(out))
    return out, got


def long_500k_inputs(cfg, device, seed=0) -> tuple[dict, torch.Tensor]:
    """A serving pool for one sequence of LONG_500K positions (pages of 16,
    the null page 0 beside them) with random K/V (unit normal, bf16), ssm
    state and conv history, and a table that is a random permutation of the
    pages, all from one seeded torch.Generator on the card."""
    bs = SERVE_POOL.block_size
    n_pages = LONG_500K // bs
    g = torch.Generator(device=device).manual_seed(seed)
    pools = tree_map(lambda _, sp: torch.empty(sp.shape, dtype=sp.dtype, device=device)
                     .normal_(generator=g),
                     T.paged_cache_defs(cfg, 1, n_pages + 1, bs, n_pages))
    table = (torch.randperm(n_pages, generator=g, device=device) + 1).int()[None]
    return pools, table


def long_500k_phase(device, cfg, params) -> tuple[dict, dict, dict]:
    """long_500k over a pool filled as ``long_500k_inputs`` says (not
    prefilled). First, on the first use's pages as drawn, with a seeded
    unit-normal query (``decode_long_parity``'s setting: a nearly flat
    softmax, where a skipped part moves the output most): the kernel over
    all 524,288 positions held to the plain version by the registry's bar
    and by DECODE_LONG_REL, two calls bit-equal, the plain version with a
    skipped tile or a dropped split missing DECODE_LONG_REL
    (``decode_long_faults``), and the call's times, splits and bound. Then
    LONG_STEPS ``decode_step_paged`` steps of one sequence at lengths
    524,285-524,287, the last attending over the whole cache: every
    decode_attention call held by the bar and by DECODE_LONG_REL, and a
    step's wall and device time against its read bound. Returns (summary,
    launches of the steps, the call's times)."""
    n_attn = n_shared(cfg)
    pools, table = long_500k_inputs(cfg, device)
    kv_bytes = sum(t.numel() * t.element_size() for t in pools["attn"].values())
    kp, vp = pools["attn"]["k"][0], pools["attn"]["v"][0]
    full = torch.tensor([LONG_500K], dtype=torch.int32, device=device)
    g = torch.Generator(device=device).manual_seed(2)
    q = torch.randn(1, cfg.n_heads, cfg.head_dim, generator=g, device=device).to(torch.bfloat16)
    plan = decode_plan(1, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim,
                       torch.bfloat16, table.shape[1], kp.shape[1], _build.sm_count(device))
    kern, again = decode_attention(q, kp, vp, table, full), decode_attention(q, kp, vp, table, full)
    want = decode_attention_ref(q, kp, vp, table, full)
    err = ops.assert_close(kern, want, ops.get_kernel("decode_attention").tolerance(torch.bfloat16))
    rel = rel_norm(kern, want)
    faults = {k: rel_norm(v, want) for k, v in
              decode_long_faults(q, kp, vp, table, full, plan["tile"], plan["splits"]).items()}
    same = torch.equal(kern, again)
    del kern, again, want
    log("long-500k", f"unit query over {LONG_500K} positions: max_abs_err={err!r} "
        f"rel_norm={rel!r} (limit {DECODE_LONG_REL}; plain version with a fault: "
        f"{json.dumps(faults)}), repeat_bit_equal={same}, splits={plan['splits']}")
    if not same or not rel <= DECODE_LONG_REL or not min(faults.values()) > DECODE_LONG_REL:
        raise AssertionError(f"long_500k unit query: repeat_bit_equal={same}, relative {rel}, "
                             f"faults {faults}")
    times = time_decode_shape(device, (q, kp, vp, table, full), "long_500k", iters=20)
    tok = torch.tensor([[1]], device=device)
    reset_launches()
    errs, rels = [], []
    for i in range(LONG_STEPS):
        lengths = torch.tensor([LONG_500K - LONG_STEPS + i], dtype=torch.int32, device=device)
        with ops.held_to_plain("decode_attention") as held:
            _, logits = T.decode_step_paged(cfg, params, tok, pools, table, lengths)
        if len(held) != n_attn or not torch.isfinite(logits).all():
            raise AssertionError(f"long_500k step {i}: {len(held)} calls held, logits finite "
                                 f"{bool(torch.isfinite(logits).all())}")
        errs += list(held)
        rels += held.rel
        tok = logits.argmax(-1, keepdim=True)
    got = launches()
    if got != {**dict.fromkeys(WRAPPERS, 0), "decode_attention": LONG_STEPS * n_attn}:
        raise AssertionError(f"long_500k launches {got}")
    if not max(rels) <= DECODE_LONG_REL:
        raise AssertionError(f"long_500k: relative error {max(rels)} > {DECODE_LONG_REL}")
    step = replay_step(lambda: T.decode_step_paged(cfg, params, tok, pools, table, lengths), n=5)
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)
                       if t.dtype == cfg.compute_dtype)
    state_bytes = sum(t.numel() * t.element_size() for t in pools["ssm"].values())
    read = weight_bytes + kv_bytes + 2 * state_bytes
    summary = {
        "positions": LONG_500K, "steps": LONG_STEPS, "kv_pool_gb": kv_bytes / 1e9,
        "kv_bytes_a_shared_layer": kv_bytes // n_attn,
        "held_max_abs": max(errs), "held_rel_norm": rels, "rel_limit": DECODE_LONG_REL,
        "unit_query_max_abs_err": err, "unit_query_rel_norm": rel,
        "plain_version_with_a_fault_rel_norm": faults, "repeat_bit_equal": same,
        "splits": plan["splits"], "decode_step": step,
        "step_read_bytes": read, "step_read_bound_ms": read / HBM_BYTES_PER_S * 1e3,
    }
    log("long-500k", json.dumps(summary))
    del pools
    torch.cuda.empty_cache()
    return summary, got, times


def hybrid_conditioned_phase(device, cfg, params, s=2048) -> dict:
    """End-to-end checks on the weights with the shared block's attention
    rescaled by ``condition_attention`` (with the reference's init its
    softmax is near an argmax, and whole-model logits are a chaotic
    function of one bf16 ulp: the serve and score phases report that).
    Hard checks, each within the bf16 bar in relative norm: forward at
    S=2048 with every kernel "on" against "off"; request 0's first token
    and first decode-step logits through the Scheduler against the
    contiguous ``generate``."""
    condition_attention(cfg, params["shared_attn"]["attn"])
    tokens = score_tokens(cfg, device, s)
    on = T.forward(cfg, params, tokens)
    off = T.forward(dataclasses.replace(cfg, attention_kernel="off", ssm_kernel="off"), params,
                    tokens)
    score_rel = ops.rel_err(on, off)
    del on, off
    sch = Scheduler(cfg, params, SERVE_POOL, device=device)
    reqs = serve_requests(cfg)[:SERVE_POOL.max_batch]
    for r in reqs:
        sch.submit(r)
    inner, first = sch.decode_fn, {}

    def decode_fn(*args):
        out = inner(*args)
        slot = next(sl for sl, st in sch.active.items() if st.req.rid == 0)
        first["token"] = sch.active[slot].generated[0]
        first["logits"] = out[1][slot].float().clone()
        return out

    sch.decode_fn = decode_fn
    sch.step()  # admits every request, then one decode step
    gen = generate(cfg, params, torch.as_tensor(reqs[0].tokens, device=device)[None],
                   max_new_tokens=1)
    paged_rel = ops.rel_err(first["logits"], gen.logits[1][0])
    out = {"score_on_vs_off_rel_norm": score_rel, "paged_vs_contiguous_rel_norm": paged_rel,
           "same_first_token": int(gen.tokens[0, 0]) == int(first["token"])}
    log("hybrid-conditioned", json.dumps(out))
    if score_rel > BF16_BAR or paged_rel > BF16_BAR or not out["same_first_token"]:
        raise AssertionError(f"hybrid conditioned: {out}")
    return out


def expected_hybrid_train_launches(cfg) -> dict[str, int]:
    """One hybrid train step with remat 'full': each ssm layer's and each
    shared-block use's forward kernel twice (forward, recompute), the ssd
    backward's three kernels a layer and the flash backward's two a use."""
    return {**dict.fromkeys(WRAPPERS, 0), "flash_attention": 2 * n_shared(cfg),
            "flash_attention_bwd": 2 * n_shared(cfg), "ssd_chunk": 2 * cfg.n_layers,
            "ssd_chunk_bwd": 3 * cfg.n_layers}


def hybrid_train_phase(device) -> tuple[dict, dict]:
    """HYBRID_TRAIN_STEPS steps of zamba2-1.2b at full width and depth
    (B=4, S=2048 from batch_at, AdamW at the launcher's defaults, remat
    "full"). Step 0 holds every flash forward and backward call and every
    ssd forward and backward call to the plain version (their bars;
    gradients also in relative norm); launches asserted every step; steps
    1-3 timed, step 4 profiled (device busy, idle share); peak memory.
    Returns (summary, launches over every step)."""
    cfg = hybrid_config()
    tc = TrainConfig(optimizer=AdamConfig())
    ld = LoaderConfig(cfg.vocab_size, HYBRID_TRAIN_B, HYBRID_TRAIN_S, seed=0)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, tc, 0, device)
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves({"p": state["params"], "o": state["opt"]})) / 1e9
    log("hybrid-train", f"{cfg.name} x{cfg.n_layers} layers, {cfg.param_count()} params "
        f"({tree_num_params(T.model_defs(cfg))} in the tree), train state (params, mu, nu) "
        f"{state_gb:.2f} GB")
    want = expected_hybrid_train_launches(cfg)
    total = dict.fromkeys(WRAPPERS, 0)
    losses, gnorms, walls = [], [], []

    def one_step(i):
        nonlocal state
        before = launches()
        state, m = train_step(cfg, tc, state, batch_at(ld, i))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        got = {n: c - before[n] for n, c in launches().items()}
        if got != want:
            raise AssertionError(f"hybrid train step {i}: launches {got} != {want}")
        for n, c in got.items():
            total[n] += c

    reset_launches()
    t0 = time.perf_counter()
    with ops.held_to_plain("flash_attention") as ffwd, \
            ops.held_to_plain("flash_attention_bwd") as fbwd, \
            ops.held_to_plain("ssd_chunk") as sfwd, ops.held_to_plain("ssd_chunk_bwd") as sbwd:
        one_step(0)
    torch.cuda.synchronize()
    t_held = time.perf_counter() - t0
    held = [len(ffwd), len(fbwd), len(sfwd), len(sbwd)]
    if held != [2 * n_shared(cfg), n_shared(cfg), 2 * cfg.n_layers, cfg.n_layers]:
        raise AssertionError(f"step 0 held {held} flash fwd/bwd and ssd fwd/bwd calls")
    peak_step0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(1, HYBRID_TRAIN_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    busy_us, kern = device_profile(lambda: one_step(HYBRID_TRAIN_STEPS - 1), 1)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"hybrid train losses {losses} grad norms {gnorms}")
    wall_ms = float(np.median(walls)) * 1e3
    names = ("flash_fwd_wgmma_kernel", *flash_bwd_kernels(cfg.head_dim), "ssd_fwd_kernel",
             "ssd_bwd_rows_kernel", "ssd_bwd_cols_kernel", "ssd_bwd_finish_kernel")
    summary = {
        "layers": cfg.n_layers, "shared_block_uses": n_shared(cfg), "B": HYBRID_TRAIN_B,
        "S": HYBRID_TRAIN_S, "tokens_per_step": HYBRID_TRAIN_B * HYBRID_TRAIN_S,
        "train_state_gb": state_gb, "losses": losses, "grad_norms": gnorms,
        "step0_s_held_to_plain": t_held,
        "step0_flash_fwd_vs_plain_max_abs": list(ffwd), "step0_flash_fwd_rel_norm": ffwd.rel,
        "step0_flash_bwd_vs_plain_max_abs": list(fbwd), "step0_flash_bwd_rel_norm": fbwd.rel,
        "step0_flash_bwd_plain_max_abs_grad": fbwd.scale,
        "step0_ssd_fwd_vs_plain_max_abs": max(sfwd), "step0_ssd_fwd_rel_norm_max": max(sfwd.rel),
        "step0_ssd_bwd_vs_plain_max_abs": max(sbwd), "step0_ssd_bwd_rel_norm_max": max(sbwd.rel),
        "step_wall_ms": [w * 1e3 for w in walls], "step_wall_ms_median": wall_ms,
        "tokens_per_s": HYBRID_TRAIN_B * HYBRID_TRAIN_S / (wall_ms / 1e3),
        "step_device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "kernel_launches_per_step_profiled": sum(c for _, c in kern.values()),
        "port_kernel_launches_per_step": {k: c for k, c in want.items() if c},
        # against the launches above: whether the profiler dropped events
        "profiled_port_kernels": {n: sum(c for k, (_, c) in kern.items() if n in k)
                                  for n in names},
        "port_kernel_device_ms": {n: sum(t for k, (t, _) in kern.items() if n in k) / 1e3
                                  for n in names},
        "peak_gb_steps_1_4": peak / 1e9, "peak_gb_step0_held": peak_step0 / 1e9,
        "top_kernels_us_per_step": top_by_prefix({k: t for k, (t, _) in kern.items()}, 10),
    }
    log("hybrid-train", json.dumps(summary))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return summary, total


def hybrid_run(device) -> dict:
    """``chip_smoke.py --hybrid`` (a fresh process): zamba2-1.2b at full
    width and depth. First the kernels alone at the hybrid's new shapes
    (flash forward at the score shape and backward at the train shape, D =
    64, 32/32 heads, beside SDPA; the SSD pair at state 64 at the train,
    score and prefill shapes), then serve (with decode timed at the busiest
    step's snapshot, group 1), score, long_500k and train. Returns the
    launches of every main path by kernel, the times of the new shapes and
    each phase's summary."""
    log("hybrid", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    cfg = hybrid_config()
    sms = _build.sm_count(device)
    for label, (b, nc, *rest) in SSD_HYBRID.items():
        log("hybrid", f"ssd plan at the {label} shape: {json.dumps(ssd_plan(b * nc, *rest, sms))}")
    times = {"flash_attention": time_attention(device, 1, 32, 32, 2048, 64),
             "flash_attention_bwd": time_flash_bwd(device, HYBRID_TRAIN_B, 32, 32,
                                                   HYBRID_TRAIN_S, 64),
             **time_ssd(device, SSD_HYBRID)}
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log("hybrid", f"{cfg.name}: {cfg.n_layers} ssm layers + {n_shared(cfg)} uses of the shared "
        f"block, {tree_num_params(T.model_defs(cfg))} params ({cfg.param_count()} counted), "
        f"{nbytes / 1e9:.2f} GB on the card, drawn in {time.perf_counter() - t0:.1f} s")
    out, total, decode = {}, dict.fromkeys(WRAPPERS, 0), {}
    times["decode_attention"] = decode

    def done(phase, t0, got):
        for n, c in got.items():
            total[n] += c
        log(phase, f"launches {got}; done in {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out["serve"], got, snap = hybrid_serve_phase(device, cfg, params)
    decode["serve"] = time_decode_shape(device, snap, "hybrid serve snapshot", iters=200)
    del snap
    done("hybrid-serve", t0, got)
    t0 = time.perf_counter()
    out["score"], got = hybrid_score_phase(device, cfg, params)
    done("hybrid-score", t0, got)
    t0 = time.perf_counter()
    out["long_500k"], got, decode["long_500k"] = long_500k_phase(device, cfg, params)
    done("long-500k", t0, got)
    out["conditioned"] = hybrid_conditioned_phase(device, cfg, params)
    del params
    t0 = time.perf_counter()
    out["train"], got = hybrid_train_phase(device)
    done("hybrid-train", t0, got)
    return {"launches": total, "times": times, "phases": out}


# ---------------------------------------------------------------------------
# phases 20-21: the moe and encdec families, in fresh processes (--moe,
# --encdec)
# ---------------------------------------------------------------------------

MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 4, 2, 2048, 5
ENC_B, DEC_S, ENC_TRAIN_STEPS = 8, 448, 5  # Whisper's text context, 448 tokens


def moe_config(n_layers=None):
    """qwen2-moe-a2.7b at full width (d 2048, MHA 16/16 of head_dim 128 with
    qkv biases, 60 experts top-4 of d_ff 1408 and a shared expert of 5632,
    capacity factor 1.25, vocab 151,936), every kernel route "on"; 24
    layers, or `n_layers`."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), attention_kernel="on",
                              decode_kernel="on")
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


def encdec_config():
    """whisper-small at full width and depth (12 encoder and 12 decoder
    layers, d 768, MHA 12/12 of head_dim 64, d_ff 3072, 1,500 frames,
    vocab 51,865), every kernel route "on"."""
    return dataclasses.replace(get_config("whisper-small"), attention_kernel="on",
                               decode_kernel="on")


class route_log:
    """Record the scatter route's dispatch of every ``layers.moe`` call made
    while open: (expert ids (T*K,), kept mask (T*K,)) a call, in order."""

    def __enter__(self):
        self.real = L.scatter_slots
        calls = self.calls = []

        def spy(cfg, p, x):
            out = self.real(cfg, p, x)
            calls.append((out[2].clone(), out[4].clone()))
            return out

        L.scatter_slots = spy
        return calls

    def __exit__(self, *exc):
        L.scatter_slots = self.real
        return False


def route_summary(calls) -> dict:
    """Pairs routed and dropped over `calls` (a ``route_log``)."""
    pairs = sum(int(e.numel()) for e, _ in calls)
    dropped = sum(int((~k).sum()) for _, k in calls)
    return {"moe_calls": len(calls), "pairs": pairs, "dropped": dropped,
            "dropped_share": dropped / max(pairs, 1)}


def route_flips(a, b) -> dict:
    """(token, slot) pairs whose expert or kept flag differ between two
    ``route_log`` records of the same calls (kernels on vs off)."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} vs {len(b)} moe calls")
    expert = sum(int((ea != eb).sum()) for (ea, _), (eb, _) in zip(a, b))
    kept = sum(int((ka != kb).sum()) for (_, ka), (_, kb) in zip(a, b))
    first = next((i for i, ((ea, ka), (eb, kb)) in enumerate(zip(a, b))
                  if not (torch.equal(ea, eb) and torch.equal(ka, kb))), None)
    return {"expert_flips": expert, "kept_flips": kept, "first_layer_with_a_flip": first}


def family_serve_phase(device, cfg, params, reqs, n_attn, flash_per_prefill, tag):
    """The Scheduler with `reqs` at full width (the serve phase's pool).

    Hard checks: every request ends with its token count; decode_attention
    launches = decode steps x `n_attn`, flash_attention = prefills x
    `flash_per_prefill` (the encdec encoder at admission; prefill itself
    passes a cache); the pools never reallocated; every decode_attention
    call of the first 4 decode steps and every flash call of the first
    step's admissions held to the plain version. Reported: tokens/s, a
    replayed decode step at the busiest state, the moe routes' drops in the
    held steps. Returns (summary, launches, the busiest step's decode
    snapshot (q, k_pool, v_pool, table, lengths) of layer 0)."""
    sch = Scheduler(cfg, params, SERVE_POOL, device=device)
    ptrs = sch.pool.data_ptrs()
    for r in reqs:
        sch.submit(r)
    inner = sch.decode_fn
    held, busiest, routes = [], {}, []

    def decode_fn(params_, tokens, pools, table, lengths):
        if len(held) < 4:
            with ops.held_to_plain("decode_attention") as errs, route_log() as rl:
                out = inner(params_, tokens, pools, table, lengths)
            held.append(errs)
            routes.extend(rl)
        else:
            out = inner(params_, tokens, pools, table, lengths)
        live = int(lengths.sum())
        if live > busiest.get("live", -1):
            busiest.update(live=live, tokens=tokens.clone(), table=table.clone(),
                           lengths=lengths.clone())
        return out

    sch.decode_fn = decode_fn
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ops.held_to_plain("flash_attention") as held_flash, route_log() as prefill_routes:
        sch.step()  # admits the first max_batch requests, then one decode step
    admitted = sch.stats.steps[0].admitted
    results, stats = sch.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launches()
    prefills = sum(st.admitted for st in stats.steps)
    want = {**dict.fromkeys(WRAPPERS, 0), "flash_attention": prefills * flash_per_prefill,
            "decode_attention": stats.decode_steps * n_attn}
    if got != want or stats.decode_steps == 0:
        raise AssertionError(f"{tag} serve launches {got} != {want}")
    if [len(e) for e in held] != [n_attn] * 4:
        raise AssertionError(f"{tag}: held decode calls a step {[len(e) for e in held]}")
    if len(held_flash) != admitted * flash_per_prefill or admitted == 0:
        raise AssertionError(f"{tag}: {len(held_flash)} flash calls held for {admitted} "
                             "admissions")
    for r in reqs:
        toks = results[r.rid]
        if toks.shape != (r.max_new_tokens,) or not np.all((0 <= toks) & (toks < cfg.vocab_size)):
            raise AssertionError(f"{tag} request {r.rid}: tokens {toks.shape}")
    if sch.pool.data_ptrs() != ptrs:
        raise AssertionError(f"the {tag} pools were reallocated")
    args = (params, busiest["tokens"], sch.pool.pools, busiest["table"], busiest["lengths"])
    step = replay_step(lambda: T.decode_step_paged(cfg, *args))
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)
                       if t.dtype == cfg.compute_dtype)
    n_tokens = int(sum(len(v) for v in results.values()))
    summary = {
        "requests": len(reqs), "tokens": n_tokens, "prefills": prefills,
        "decode_steps": stats.decode_steps, "preemptions": stats.preemptions,
        "peak_active": stats.peak_active, "peak_occupancy": stats.peak_occupancy,
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "decode_ms_per_step_incl_admission": wall * 1e3 / stats.decode_steps,
        "decode_vs_plain_max_abs_per_step": [max(e) for e in held],
        "decode_vs_plain_rel_norm_max": max(r for e in held for r in e.rel),
        "held_admissions": admitted,
        "flash_vs_plain_max_abs": max(held_flash, default=0.0),
        "flash_vs_plain_rel_norm_max": max(held_flash.rel, default=0.0),
        "busiest_live_tokens": busiest["live"], "decode_step": step,
        "weight_bytes_read_per_step": weight_bytes,
        "decode_step_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
    }
    if cfg.family == "moe":
        summary["routes_first_step"] = route_summary(prefill_routes)  # admissions + a decode
        summary["routes_held_decode_steps"] = route_summary(routes)
    log(f"{tag}-serve", json.dumps(summary))
    gen_q = torch.Generator(device=device).manual_seed(1)
    kv = sch.pool.pools["self"] if cfg.family == "encdec" else sch.pool.pools
    snap = (torch.randn(SERVE_POOL.max_batch, cfg.n_heads, cfg.head_dim, device=device,
                        generator=gen_q).to(cfg.compute_dtype),
            kv["k"][0], kv["v"][0], busiest["table"], busiest["lengths"] + 1)
    return summary, got, snap


def family_score_phase(device, cfg, params, tokens, n_flash, tag, **kw) -> tuple[dict, dict]:
    """forward() at full width on `tokens` (and the encdec's `enc_embeds`
    in `kw`): `n_flash` flash_attention launches, each held to the plain
    version on its own inputs; finite logits. The on vs off logit
    difference is reported (chaotic at the reference's init), and for the
    moe family the route flips between the two and the dropped pairs."""
    b, s = tokens.shape
    T.forward(cfg, params, tokens[:, :128], **{k: v[:, :256] for k, v in kw.items()})  # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on = T.forward(cfg, params, tokens, **kw)
    torch.cuda.synchronize()
    t_on = time.perf_counter() - t0
    got = launches()
    if got != {**dict.fromkeys(WRAPPERS, 0), "flash_attention": n_flash}:
        raise AssertionError(f"{tag} score launches {got}: want {n_flash} flash_attention")
    if on.shape != (b, s, cfg.vocab_size) or not torch.isfinite(on).all():
        raise AssertionError(f"{tag} score logits {tuple(on.shape)} not finite")
    with ops.held_to_plain("flash_attention") as flash, route_log() as on_routes:
        T.forward(cfg, params, tokens, **kw)
    if len(flash) != n_flash:
        raise AssertionError(f"{len(flash)} flash calls held")
    with route_log() as off_routes:
        off = T.forward(dataclasses.replace(cfg, attention_kernel="off"), params, tokens, **kw)
    out = {"B": b, "S": s, "seconds_on": t_on, "tokens_per_s_on": b * s / t_on,
           "flash_vs_plain_max_abs": list(flash), "flash_vs_plain_rel_norm": flash.rel,
           "reported_on_vs_off_logits_rel_norm": ops.rel_err(on, off),
           "reported_on_vs_off_within_bar": within_bf16_bar(on, off),
           "logits_abs_max": off.abs().max().item()}
    if cfg.family == "moe":
        out["routes"] = route_summary(on_routes)
        out["reported_route_flips_on_vs_off"] = route_flips(on_routes, off_routes)
    log(f"{tag}-score", json.dumps(out))
    return out, got


def family_train_phase(device, cfg, steps, batch_fn, tag, prepare=None) -> tuple[dict, dict]:
    """`steps` train steps of `cfg` (AdamW at the launcher's defaults,
    remat "full": each self-attention's flash forward twice a step and its
    backward's two kernels once), the batches from ``batch_fn(i)``, from
    the train state's parameters after ``prepare(params)`` (if given). Step 0
    holds every flash forward and backward call to the plain version (bars
    2e-2 and 5e-2; gradients also in relative norm); launches asserted
    every step; steps 1..steps-2 timed, the last profiled; peak memory.
    Returns (summary, launches over every step)."""
    n_attn = cfg.n_layers + (cfg.n_encoder_layers if cfg.family == "encdec" else 0)
    tc = TrainConfig(optimizer=AdamConfig())
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, tc, 0, device)
    if prepare is not None:
        prepare(state["params"])
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves({"p": state["params"], "o": state["opt"]})) / 1e9
    log(f"{tag}-train", f"{cfg.name} x{cfg.n_layers} layers, "
        f"{tree_num_params(T.model_defs(cfg))} params, train state (params, mu, nu) "
        f"{state_gb:.2f} GB")
    want = {**dict.fromkeys(WRAPPERS, 0), "flash_attention": 2 * n_attn,
            "flash_attention_bwd": 2 * n_attn}
    total = dict.fromkeys(WRAPPERS, 0)
    losses, gnorms, walls = [], [], []

    def one_step(i):
        nonlocal state
        before = launches()
        state, m = train_step(cfg, tc, state, batch_fn(i))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        got = {n: c - before[n] for n, c in launches().items()}
        if got != want:
            raise AssertionError(f"{tag} train step {i}: launches {got} != {want}")
        for n, c in got.items():
            total[n] += c

    reset_launches()
    t0 = time.perf_counter()
    with ops.held_to_plain("flash_attention") as ffwd, \
            ops.held_to_plain("flash_attention_bwd") as fbwd:
        one_step(0)
    torch.cuda.synchronize()
    t_held = time.perf_counter() - t0
    if [len(ffwd), len(fbwd)] != [2 * n_attn, n_attn]:
        raise AssertionError(f"{tag} step 0 held {len(ffwd)} flash fwd, {len(fbwd)} bwd calls")
    worst = max(fbwd.rel)
    if worst > GRAD_BAR:
        raise AssertionError(f"{tag} step 0: flash backward relative error {worst}")
    peak_step0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(1, steps - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    busy_us, kern = device_profile(lambda: one_step(steps - 1), 1)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"{tag} train losses {losses} grad norms {gnorms}")
    wall_ms = float(np.median(walls)) * 1e3
    names = ("flash_fwd_wgmma_kernel", *flash_bwd_kernels(cfg.head_dim))
    summary = {
        "layers": cfg.n_layers, "attention_layers": n_attn,
        "train_state_gb": state_gb, "losses": losses, "grad_norms": gnorms,
        "step0_s_held_to_plain": t_held,
        "step0_flash_fwd_vs_plain_max_abs": max(ffwd), "step0_flash_fwd_rel_norm_max": max(ffwd.rel),
        "step0_flash_bwd_vs_plain_max_abs": max(fbwd), "step0_flash_bwd_rel_norm_max": worst,
        "step0_flash_bwd_plain_max_abs_grad": max(fbwd.scale),
        "step_wall_ms": [w * 1e3 for w in walls], "step_wall_ms_median": wall_ms,
        "step_device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "port_kernel_launches_per_step": {k: c for k, c in want.items() if c},
        "profiled_port_kernels": {n: sum(c for k, (_, c) in kern.items() if n in k)
                                  for n in names},
        "port_kernel_device_ms": {n: sum(t for k, (t, _) in kern.items() if n in k) / 1e3
                                  for n in names},
        "peak_gb_steps_1_4": peak / 1e9, "peak_gb_step0_held": peak_step0 / 1e9,
        "top_kernels_us_per_step": top_by_prefix({k: t for k, (t, _) in kern.items()}, 10),
    }
    log(f"{tag}-train", json.dumps(summary))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return summary, total


def family_run(device, tag, cfg, times, phases) -> dict:
    """Draw `cfg`'s serving weights, run `phases` (each ``fn(params) ->
    (name, summary, launches[, decode snapshot])``) in order, then free the
    weights. Returns the launches by kernel, `times` (with the decode
    snapshot's) and each phase's summary."""
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(tag, f"{cfg.name}: {cfg.n_layers} layers, {tree_num_params(T.model_defs(cfg))} params "
        f"({cfg.param_count()} counted, {cfg.active_param_count()} active a token), "
        f"{nbytes} bytes ({nbytes / 1e9:.2f} GB) on the card, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    out, total = {"param_bytes": nbytes}, dict.fromkeys(WRAPPERS, 0)
    for phase in phases:
        t0 = time.perf_counter()
        name, summary, got, *snap = phase(params)
        out[name] = summary
        for n, c in got.items():
            total[n] += c
        if snap:
            times["decode_attention"] = time_decode_shape(device, snap[0],
                                                          f"{tag} serve snapshot", iters=200)
            del snap
        log(f"{tag}-{name}", f"launches {got}; done in {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": total, "times": times, "phases": out}


def moe_run(device) -> dict:
    """``chip_smoke.py --moe`` (a fresh process): qwen2-moe-a2.7b at full
    width. First the flash kernels at its shapes (MHA 16/16, D=128, causal:
    the forward at the score shape, B=1, S=2048; the backward at the train
    shape, B=2, S=2048; SDPA beside them computes the same function); then,
    on random bf16 weights from seed 0 (29.25 GB), serve (12 requests, all
    24 layers; decode timed at the busiest step's snapshot, D=128 group 1)
    and score (B=1, S=2048), with every kernel call held and the routes'
    drops and on-vs-off flips reported; then train at full width cut to
    MOE_TRAIN_LAYERS layers (its float32 params, grads and AdamW moments
    take 16 B a parameter: 4 layers 46 GB, 24 layers 229 GB), B=2, S=2048."""
    log("moe", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    cfg = moe_config()
    times = {"flash_attention": time_attention(device, 1, 16, 16, 2048, 128),
             "flash_attention_bwd": time_flash_bwd(device, MOE_TRAIN_B, 16, 16, MOE_TRAIN_S,
                                                   128)}
    phases = [
        lambda p: ("serve", *family_serve_phase(device, cfg, p, serve_requests(cfg),
                                                cfg.n_layers, 0, "moe")),
        lambda p: ("score", *family_score_phase(device, cfg, p, score_tokens(cfg, device, 2048),
                                                cfg.n_layers, "moe")),
    ]
    out = family_run(device, "moe", cfg, times, phases)
    tcfg = moe_config(MOE_TRAIN_LAYERS)
    log("moe-train", f"cut 24 -> {MOE_TRAIN_LAYERS} layers at full width: "
        f"{tree_num_params(T.model_defs(tcfg))} params, 16 B each in float32 params, grads "
        "and AdamW moments")
    ld = LoaderConfig(tcfg.vocab_size, MOE_TRAIN_B, MOE_TRAIN_S, seed=0)
    t0 = time.perf_counter()
    out["phases"]["train"], got = family_train_phase(device, tcfg, MOE_TRAIN_STEPS,
                                                     lambda i: batch_at(ld, i), "moe")
    for n, c in got.items():
        out["launches"][n] += c
    log("moe-train", f"launches {got}; done in {time.perf_counter() - t0:.1f} s")
    return out


def frames(cfg, b, device, seed) -> torch.Tensor:
    """Seeded unit-normal (b, encoder_len, d_model) frame embeddings on the
    card (the audio frontend is a stub in both packages)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(b, cfg.encoder_len, cfg.d_model, generator=g, device=device)


def encdec_requests(cfg, n=SERVE_REQUESTS, seed=0) -> list[Request]:
    """``serve_requests`` with a seeded (encoder_len, d_model) float32
    ``enc_embeds`` each."""
    rng = np.random.default_rng(seed + 1)
    return [dataclasses.replace(r, enc_embeds=rng.standard_normal(
        (cfg.encoder_len, cfg.d_model)).astype(np.float32)) for r in serve_requests(cfg, n, seed)]


def condition_encdec(cfg, params) -> None:
    """``condition_attention`` on every attention of the encdec stacks:
    the encoder's, the decoder's and its cross attention."""
    for attn in (params["encoder"]["attn"], params["decoder"]["attn"],
                 params["decoder"]["xattn"]):
        condition_attention(cfg, attn)


class bwd_log:
    """Record, without raising, how every flash_attention_bwd call made
    while open compares with its plain version on the same inputs: the
    plain gradients' largest magnitude, the relative error norm of each of
    dq, dk, dv and the elements outside the registry's bf16 bar."""

    def __enter__(self):
        self.real = ops.dispatch
        rows = self.rows = []
        tol = ops.get_kernel("flash_attention_bwd").tolerance(torch.bfloat16)

        def spy(name, *args, **kw):
            out = self.real(name, *args, **kw)
            if name == "flash_attention_bwd":
                kw.pop("mode", None)
                want = flash_attention_bwd_ref(*args, **kw)
                rows.append({
                    "S": args[0].shape[2], "causal": kw.get("causal", True),
                    "plain_abs_max": max(w.abs().max().item() for w in want),
                    "rel_norm": [ops.rel_err(g, w) for g, w in zip(out, want)],
                    "outside_bar": sum(int(((g.double() - w.double()).abs()
                                            > tol.atol + tol.rtol * w.double().abs()).sum())
                                       for g, w in zip(out, want))})
            return out

        ops.dispatch = spy
        return rows

    def __exit__(self, *exc):
        ops.dispatch = self.real
        return False


def reference_init_backward(device, cfg, batch) -> dict:
    """One ``local_grads`` of whisper-small with the reference's init
    (reported, not gated): every flash backward call against its plain
    version by ``bwd_log``. With this init the 24 attention layers are near
    an argmax (scores in the hundreds) and the cotangents grow by orders of
    magnitude a layer going back, so single elements of dq, dk, dv cancel
    large terms and fall outside the elementwise bar in the kernel and the
    plain float32 version alike; the train phase holds every call on
    conditioned attention (``condition_encdec``)."""
    params = T.init_train_params(cfg, 0, device)
    with bwd_log() as rows:
        loss, _ = local_grads(cfg, TrainConfig(), params, batch)
    out = {"loss": float(loss), "calls": len(rows),
           "rel_norm_max": max(max(r["rel_norm"]) for r in rows),
           "plain_abs_max": max(r["plain_abs_max"] for r in rows),
           "calls_with_elements_outside_bar": sum(1 for r in rows if r["outside_bar"]),
           "elements_outside_bar": sum(r["outside_bar"] for r in rows), "per_call": rows}
    log("encdec-reference-init-backward", json.dumps(out))
    del params, rows
    gc.collect()
    torch.cuda.empty_cache()
    return out


def encdec_conditioned_phase(device, cfg, params) -> dict:
    """End-to-end checks on the weights with every attention (encoder,
    decoder, cross) rescaled by ``condition_attention`` (with the reference's
    init whole-model logits are chaotic; the score phase reports that).
    Hard checks, each within the bf16 bar in relative norm: forward at
    B=ENC_B, S=DEC_S with attention_kernel "on" against "off"; request 0's
    first token and first decode-step logits through the Scheduler against
    the contiguous ``generate``."""
    condition_encdec(cfg, params)
    tokens = score_tokens(cfg, device, ENC_B * DEC_S).reshape(ENC_B, DEC_S)
    enc = frames(cfg, ENC_B, device, 3)
    on = T.forward(cfg, params, tokens, enc_embeds=enc)
    off = T.forward(dataclasses.replace(cfg, attention_kernel="off"), params, tokens,
                    enc_embeds=enc)
    score_rel = ops.rel_err(on, off)
    del on, off
    sch = Scheduler(cfg, params, SERVE_POOL, device=device)
    reqs = encdec_requests(cfg)[:SERVE_POOL.max_batch]
    for r in reqs:
        sch.submit(r)
    inner, first = sch.decode_fn, {}

    def decode_fn(*args):
        out = inner(*args)
        slot = next(sl for sl, st in sch.active.items() if st.req.rid == 0)
        first["token"] = sch.active[slot].generated[0]
        first["logits"] = out[1][slot].float().clone()
        return out

    sch.decode_fn = decode_fn
    sch.step()  # admits every request, then one decode step
    gen = generate(cfg, params, torch.as_tensor(reqs[0].tokens, device=device)[None],
                   max_new_tokens=1,
                   enc_embeds=torch.as_tensor(reqs[0].enc_embeds, device=device)[None])
    paged_rel = ops.rel_err(first["logits"], gen.logits[1][0])
    out = {"score_on_vs_off_rel_norm": score_rel, "paged_vs_contiguous_rel_norm": paged_rel,
           "same_first_token": int(gen.tokens[0, 0]) == int(first["token"])}
    log("encdec-conditioned", json.dumps(out))
    if score_rel > BF16_BAR or paged_rel > BF16_BAR or not out["same_first_token"]:
        raise AssertionError(f"encdec conditioned: {out}")
    return out


def encdec_run(device) -> dict:
    """``chip_smoke.py --encdec`` (a fresh process): whisper-small at full
    width and depth. First the flash kernels at its shapes (MHA 12/12,
    D=64): the encoder's non-causal self-attention over S = Sk = 1,500
    frames (forward at B=1, the serve admission, and B=ENC_B; backward at
    B=ENC_B), the decoder's causal S=DEC_S (forward and backward at
    B=ENC_B), beside SDPA; then, on random bf16 weights from seed 0, serve
    (12 requests, each with seeded (1500, 768) frames; the encoder runs at
    admission; decode timed at the busiest step's snapshot, D=64 group 1),
    score (B=ENC_B, S=DEC_S over 1,500 frames), the conditioned end-to-end
    checks, one reported backward at the reference's init
    (``reference_init_backward``), and ENC_TRAIN_STEPS train steps at full
    depth (B=ENC_B, S=DEC_S, seeded frames a step) from a train state whose
    attention is conditioned (``condition_encdec``)."""
    log("encdec", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    cfg = encdec_config()
    se, h, d = cfg.encoder_len, cfg.n_heads, cfg.head_dim
    times = {
        "flash_attention": time_attention(device, ENC_B, h, h, se, d, causal=False),
        "flash_attention_b1": time_attention(device, 1, h, h, se, d, causal=False),
        "flash_attention_decoder": time_attention(device, ENC_B, h, h, DEC_S, d),
        "flash_attention_bwd": time_flash_bwd(device, ENC_B, h, h, se, d, causal=False),
        "flash_attention_bwd_decoder": time_flash_bwd(device, ENC_B, h, h, DEC_S, d),
    }
    n_attn = cfg.n_layers + cfg.n_encoder_layers

    def score(p):
        tokens = score_tokens(cfg, device, ENC_B * DEC_S).reshape(ENC_B, DEC_S)
        return ("score", *family_score_phase(device, cfg, p, tokens, n_attn, "encdec",
                                             enc_embeds=frames(cfg, ENC_B, device, 2)))

    phases = [
        lambda p: ("serve", *family_serve_phase(device, cfg, p, encdec_requests(cfg),
                                                cfg.n_layers, cfg.n_encoder_layers, "encdec")),
        score,
        lambda p: ("conditioned", encdec_conditioned_phase(device, cfg, p),
                   dict.fromkeys(WRAPPERS, 0)),
    ]
    out = family_run(device, "encdec", cfg, times, phases)
    ld = LoaderConfig(cfg.vocab_size, ENC_B, DEC_S, seed=0)
    batch_fn = lambda i: {**batch_at(ld, i),  # noqa: E731
                          "enc_embeds": frames(cfg, ENC_B, device, 100 + i)}
    out["phases"]["reference_init_backward"] = reference_init_backward(device, cfg,
                                                                       batch_fn(0))
    t0 = time.perf_counter()
    out["phases"]["train"], got = family_train_phase(
        device, cfg, ENC_TRAIN_STEPS, batch_fn, "encdec",
        prepare=lambda p: condition_encdec(cfg, p))
    for n, c in got.items():
        out["launches"][n] += c
    log("encdec-train", f"launches {got}; done in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 22: the training options at full width, in a fresh process (--options)
# ---------------------------------------------------------------------------

OPT_S, OPT_DOTS_STEPS = 4096, 3  # the reference's train_4k sequence; its batch of 256 cut to 1
PREFILL_S, PREFILL_NEW, PREFILL_CHECK_S = 32768, 4, 4096  # the reference's prefill_32k


def options_config():
    """llama3-405b (arXiv:2407.21783) at full width, cut 126 -> 1 layer: bf16
    weights and gradients take 14.78 GB each; bf16 moments 29.56 GB (float32
    ones 59.12 GB, 88.7 GB of state with them: more than the card)."""
    return dataclasses.replace(get_config("llama3-405b"), n_layers=1, remat="dots")


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst |got - want| in bf16 ulps of max(|want|, 2^-15 of the slice's
    largest): the floor measures what a cancellation leaves (the float32
    rounding of its terms) against the terms, as
    tests/test_torch_train_options.py does."""
    a, b = got.double(), want.double()
    floor = 2.0 ** -15 * max(float(b.abs().max()), 2.0 ** -100)
    mag = torch.clamp(torch.maximum(a.abs(), b.abs()), min=floor)
    return float(((a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


@contextlib.contextmanager
def captured_update(slices):
    """While open, ``train.step.adam_update`` is wrapped so that one
    ``train_step``'s update of a few slices (``{name: tree -> tensor}``) is
    recorded: p, g, mu, nu before and p, mu, nu after, in float64 on the
    card, with the step, the grad norm and the config. Yields the record."""
    orig, rec = train_mod.adam_update, {}

    def wrapped(cfg, params, grads, opt, step):
        take = lambda tree: {n: f(tree).detach().double().clone()  # noqa: E731
                             for n, f in slices.items()}
        before = [take(t) for t in (params, grads, opt["mu"], opt["nu"])]
        out = orig(cfg, params, grads, opt, step)
        rec.update(cfg=cfg, step=int(step), gnorm=float(out[2]["grad_norm"]), before=before,
                   after=[take(out[0]), take(out[1]["mu"]), take(out[1]["nu"])])
        return out

    train_mod.adam_update = wrapped
    try:
        yield rec
    finally:
        train_mod.adam_update = orig


def update_vs_formula(rec) -> dict:
    """The recorded slices' update against the reference's AdamW formula
    (``repro/optim/adam.py`` upd) in float64 from the step's own gradients
    and moments: each stored value within one bf16 ulp (``bf16_ulps``)."""
    c, t = rec["cfg"], rec["step"] + 1
    p0, g0, mu0, nu0 = rec["before"]
    scale = min(1.0, c.grad_clip / (rec["gnorm"] + 1e-12))
    lr = c.lr_at(rec["step"])
    out = {}
    for name in p0:
        g = g0[name] * scale
        mu = mu0[name] * c.b1 + (1 - c.b1) * g
        nu = nu0[name] * c.b2 + (1 - c.b2) * g * g
        delta = (mu / (1 - c.b1 ** t)) / (torch.sqrt(nu / (1 - c.b2 ** t)) + c.eps)
        p = p0[name] - lr * (delta + c.weight_decay * p0[name])
        got_p, got_mu, got_nu = (a[name] for a in rec["after"])
        out[name] = {"p_ulps": bf16_ulps(got_p, p), "mu_ulps": bf16_ulps(got_mu, mu),
                     "nu_ulps": bf16_ulps(got_nu, nu), "elements": p.numel(),
                     "p_moved": int((got_p != p0[name]).sum())}
    worst = max(max(v[k] for k in ("p_ulps", "mu_ulps", "nu_ulps")) for v in out.values())
    if worst > 1.0:
        raise AssertionError(f"the step's update is {worst} bf16 ulps from the formula: {out}")
    return out


def options_flash(device) -> dict:
    """The flash kernels at llama3-405b's head layout (128/8 heads, D=128,
    causal, B=1, S=4,096), before the model exists (the plain backward's
    S x S float32 scores take ~8.6 GB a call): one forward and backward
    through the registry held to the plain version (``held_to_plain``),
    then each timed beside the plain version, the bound and SDPA."""
    cfg = options_config()
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (t.requires_grad_() for t in flash_inputs(1, h, kv, OPT_S, OPT_S, d,
                                                         torch.bfloat16, device, seed=3))
    do = flash_inputs(1, h, h, OPT_S, OPT_S, d, torch.bfloat16, device, seed=4)[0]
    with ops.held_to_plain("flash_attention") as ffwd, \
            ops.held_to_plain("flash_attention_bwd") as fbwd:
        o = ops.dispatch("flash_attention", q, k, v, causal=True, mode="on")
        o.backward(do)
    torch.cuda.synchronize()
    if [len(ffwd), len(fbwd)] != [1, 1] or max(fbwd.rel) > GRAD_BAR:
        raise AssertionError(f"options flash held: {list(ffwd)} {list(fbwd)} {fbwd.rel}")
    held = {"fwd_max_abs": ffwd[0], "fwd_rel": ffwd.rel[0], "bwd_max_abs": fbwd[0],
            "bwd_rel": fbwd.rel[0], "bwd_plain_max_abs_grad": fbwd.scale[0]}
    log("options", f"flash at {h}/{kv} heads S={OPT_S} D={d} held: {json.dumps(held)}")
    del q, k, v, do, o
    gc.collect()
    torch.cuda.empty_cache()
    return {"held": held,
            "flash_attention": time_attention(device, 1, h, kv, OPT_S, d),
            "flash_attention_bwd": time_flash_bwd(device, 1, h, kv, OPT_S, d)}


def options_train(device) -> tuple[dict, dict]:
    """llama3-405b at full width, 1 layer: OPT_DOTS_STEPS train steps with
    bf16 weights and moments under remat "dots", then one under "full",
    B=1, S=OPT_S from ``batch_at``; AdamW at the launcher's defaults but
    warmup 1 (a step then moves the bf16 weights by several ulps). Each step
    profiled (wall under the profiler, device busy, idle share), its
    launches asserted (the flash forward twice: forward and recompute under
    either policy; the backward's two kernels), its peak memory; step 1's
    update of sampled slices of embed, mlp and a norm held to the formula.
    The wall of a step is taken inside the profiled window (the profiler's
    own bookkeeping after it is not counted)."""
    cfg = options_config()
    tc = TrainConfig(optimizer=AdamConfig(state_dtype=torch.bfloat16, warmup_steps=1))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, tc, 0, device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n = tree_num_params(T.model_defs(cfg))
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree))  # noqa
    p_bytes, m_bytes = nbytes(state["params"]), nbytes(state["opt"])
    if {t.dtype for t in tree_leaves({"p": state["params"], "o": state["opt"]})} != {
            torch.bfloat16}:
        raise AssertionError("the llama train state is not all bf16")
    state_info = {
        "params": n, "param_bytes": p_bytes, "grad_bytes": p_bytes, "moment_bytes": m_bytes,
        "state_bytes_with_grads": 2 * p_bytes + m_bytes,
        "state_bytes_with_float32_moments": 2 * p_bytes + 2 * 4 * n, "drawn_s": t_init}
    log("options-train", f"{cfg.name} x{cfg.n_layers} layer: {json.dumps(state_info)}")
    ld = LoaderConfig(cfg.vocab_size, 1, OPT_S, seed=0)
    want = {**dict.fromkeys(WRAPPERS, 0), "flash_attention": 2, "flash_attention_bwd": 2}
    tokens = batch_at(ld, 1)["tokens"].reshape(-1)
    seen = torch.as_tensor(np.unique(tokens)[:4], device=device)
    slices = {"embed_seen_rows": lambda t: t["embed"][seen, :256],
              "embed_row_0": lambda t: t["embed"][0, :256],
              "mlp_wg": lambda t: t["blocks"]["mlp"]["wg"][0, :64, :64],
              "ln1": lambda t: t["blocks"]["ln1"][0]}
    total, steps, formula = dict.fromkeys(WRAPPERS, 0), [], None
    for i, remat in enumerate(["dots"] * OPT_DOTS_STEPS + ["full"]):
        run_cfg = dataclasses.replace(cfg, remat=remat)
        metrics = {}

        def one(i=i, run_cfg=run_cfg, metrics=metrics):
            nonlocal state
            batch = batch_at(ld, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics["m"] = train_step(run_cfg, tc, state, batch)
            torch.cuda.synchronize()
            metrics["wall"] = time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        before = launches()
        with captured_update(slices if i == 1 else {}) as rec:
            busy_us, kern = device_profile(one, 1)
        wall = metrics["wall"]
        got = {k: c - before[k] for k, c in launches().items()}
        if got != want:
            raise AssertionError(f"options train step {i}: launches {got} != {want}")
        for k, c in got.items():
            total[k] += c
        if i == 1:
            formula = update_vs_formula(rec)
        m = metrics["m"]
        steps.append({"step": i, "remat": remat, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]), "wall_ms_profiled": wall * 1e3,
                      "device_busy_ms": busy_us / 1e3, "idle_share": 1 - busy_us / 1e6 / wall,
                      "launches_profiled": sum(c for _, c in kern.values()),
                      "port_kernel_launches": {k: c for k, c in got.items() if c},
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "top_kernels_us": top_by_prefix({k: t for k, (t, _) in kern.items()}, 6)})
        log("options-train", json.dumps(steps[-1]))
    bad = [s for s in steps if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]))]
    if bad or max(s["peak_gb"] for s in steps) >= 80:
        raise AssertionError(f"options train: {steps}")
    out = {"layers": cfg.n_layers, "B": 1, "S": OPT_S, "state": state_info, "steps": steps,
           "update_vs_formula": formula}
    log("options-train", f"update vs the formula: {json.dumps(formula)}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out, total


@contextlib.contextmanager
def prefill_events():
    """While open, ``T.decode_step``'s first call (``generate``'s prefill)
    runs between two CUDA events; yields {"ms": their elapsed time}."""
    orig, out = T.decode_step, {}

    def first(*args, **kwargs):
        T.decode_step = orig
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        res = orig(*args, **kwargs)
        end.record()
        end.synchronize()
        out["ms"] = start.elapsed_time(end)
        return res

    T.decode_step = first
    try:
        yield out
    finally:
        T.decode_step = orig


def options_prefill(device) -> tuple[dict, dict]:
    """minitron-8b (arXiv:2407.14679) at full width and depth with
    blockwise attention (attention_block_k 1,024), its attention
    conditioned (``condition_attention``: at the reference's init the
    whole-model logits are chaotic). ``generate`` prefills one seeded
    PREFILL_S-token prompt and decodes PREFILL_NEW tokens, with no registry
    kernel (blockwise takes precedence; decode reads the contiguous cache):
    its prefill's wall (generate's own timer) and device time (CUDA events
    around the prefill's forward: ~45,000 launches, not profiled, whose
    trace would take longer to read than the prefill to run) and the peak
    memory. Its prefill's last-position logits are held to the flash stack
    on the same tokens with no cache (``_run_stack`` with
    blockwise_attention off: the flash forward at S = PREFILL_S, which no
    plain version can hold: its scores would take 137 GB), with only the
    last position unembedded, within the bf16 bar; at PREFILL_CHECK_S a
    blockwise prefill is held to the plain cached path the same way."""
    cfg = dataclasses.replace(get_config("minitron-8b"), blockwise_attention=True)
    off = dataclasses.replace(cfg, blockwise_attention=False)  # flash, or plain with a cache
    params = T.init_params(cfg, seed=0, device=device)
    condition_attention(cfg, params["blocks"]["attn"])
    prompt = torch.as_tensor(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (1, PREFILL_S)), device=device)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with prefill_events() as ev:
        r = generate(cfg, params, prompt, max_new_tokens=PREFILL_NEW)
    peak = torch.cuda.max_memory_allocated()
    if any(launches().values()):
        raise AssertionError(f"blockwise generate launched {launches()}")
    with torch.no_grad():
        x = T._embed(off, params, prompt)
        x, _ = T._run_stack(off, params["blocks"], x, T._arange_rows(1, PREFILL_S, device), None)
        flash_last = T._unembed(off, params, x[:, -1:])[:, 0]
        del x
    got = launches()
    if got["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"the flash stack launched {got}")
    blk_last = r.logits[0]
    err = (blk_last - flash_last).abs().max().item()
    rel = ops.rel_err(blk_last, flash_last)
    if not within_bf16_bar(blk_last, flash_last):
        raise AssertionError(f"blockwise prefill vs the flash stack: max abs {err}, rel {rel}")
    p4 = prompt[:, :PREFILL_CHECK_S]
    with torch.no_grad():
        _, l_blk = T.prefill(cfg, params, p4, T.init_cache(cfg, 1, PREFILL_CHECK_S, device))
        _, l_plain = T.prefill(off, params, p4, T.init_cache(off, 1, PREFILL_CHECK_S, device))
    err4 = (l_blk - l_plain).abs().max().item()
    if not within_bf16_bar(l_blk, l_plain):
        raise AssertionError(f"blockwise vs plain prefill at {PREFILL_CHECK_S}: {err4}")
    out = {"S": PREFILL_S, "new_tokens": PREFILL_NEW, "block_k": cfg.attention_block_k,
           "prefill_wall_s": r.prefill_s, "prefill_device_ms_events": ev["ms"],
           "decode_wall_s": r.decode_s, "peak_gb": peak / 1e9, "tokens": r.tokens.tolist(),
           "vs_flash_stack_max_abs": err, "vs_flash_stack_rel_norm": rel,
           "at_4096_vs_plain_max_abs": err4, "at_4096_vs_plain_rel_norm": ops.rel_err(l_blk,
                                                                                      l_plain)}
    log("options-prefill", json.dumps(out))
    del params, r
    gc.collect()
    torch.cuda.empty_cache()
    return out, got


def options_run(device) -> dict:
    """``chip_smoke.py --options`` (a fresh process): the training options
    at full width. TF32 stays off (float32 products exact). The flash
    kernels at llama3-405b's heads (``options_flash``), llama3-405b's bf16
    training under "dots" and "full" (``options_train``), minitron-8b's
    blockwise prefill of PREFILL_S tokens through ``generate``
    (``options_prefill``)."""
    log("options", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on: the float32 products would not be exact")
    _build.build_all()
    t0 = time.perf_counter()
    times = options_flash(device)
    log("options", f"flash done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train, total = options_train(device)
    log("options", f"train launches {total}; done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    prefill, got = options_prefill(device)
    for n, c in got.items():
        total[n] += c
    log("options", f"prefill launches {got}; done in {time.perf_counter() - t0:.1f} s")
    return {"launches": total, "times": times, "train": train, "prefill": prefill}


# ---------------------------------------------------------------------------
# phase 23: the rest of the paper's methods, in a fresh process (--solvers)
# ---------------------------------------------------------------------------

NEW_METHODS = ("extra", "dlm", "ssda", "mudag", "sliding", "dsgda", "personal")
# SSDA's grad f* holds a d x d factor a node (17.8 GB a node at rcv1's d), so
# it runs at a cut width; logistic's 8 Newton solves a node a step are
# also run on the CPU for the comparison, hence the narrower cut
SSDA_D = {"ridge": 4096, "logistic": 1024}
SSDA_STEPS = 4
PROFILED = (("extra", "ridge"), ("dlm", "ridge"), ("mudag", "ridge"),
            ("sliding", "ridge"), ("dsgda", "auc"), ("personal", "ridge"))


def method_pairs() -> list[tuple[str, str]]:
    """Every (new method, family) the registry supports on comm="dense"."""
    caps = available_solvers()
    return [(m, f) for m in NEW_METHODS for f in FAMILIES if caps[m].supports("dense", f)]


def solver_problem(method, task, d, k, n_nodes=10, q=100):
    """``paper_problem``; ``personal`` gets a per-node lam (1x to 2x the
    paper's 1/(10Q)), the capability it exists for."""
    problem = paper_problem(task, d, k, n_nodes, q)
    if method == "personal":
        problem = dataclasses.replace(problem, lam=problem.lam * np.linspace(1.0, 2.0, n_nodes))
    return problem


def solver_pairs(device, d, k, steps=10, ssda_d=SSDA_D, n_nodes=10, q=100) -> list[dict]:
    """Every new (method, family) pair through solve() on `device`, held to
    the same run on the CPU (z within DENSE_TOL_CPU, DOUBLEs equal) with no
    registry kernel launched. SSDA at its cut widths ``ssda_d`` for
    ``SSDA_STEPS`` steps, with its dual step at lam (its default, 0.05,
    diverges at lam = 1/(10 Q) in both packages); the others at their
    defaults."""
    cpu = torch.device("cpu")
    rows = []
    for method, task in method_pairs():
        width = ssda_d[task] if method == "ssda" else d
        problem = solver_problem(method, task, width, k, n_nodes, q)
        n_steps = min(steps, SSDA_STEPS) if method == "ssda" else steps
        kw = dict(steps=n_steps, record_every=max(1, n_steps // 2))
        if method == "ssda":
            kw["eta"] = float(problem.lam)
        reset_launches()
        t0 = time.perf_counter()
        res = solve(problem, method, device=device, **kw)
        t_dev = time.perf_counter() - t0
        got = launches()
        if any(got.values()):
            raise AssertionError(f"{method}/{task}: registry kernels launched {got}")
        t0 = time.perf_counter()
        ref = solve(problem, method, device=cpu, **kw)
        t_cpu = time.perf_counter() - t0
        err = float(np.max(np.abs(res.z - ref.z)))
        if not np.all(np.isfinite(res.z)) or err > DENSE_TOL_CPU:
            raise AssertionError(f"{method}/{task}: device vs CPU {err}")
        if not np.array_equal(res.doubles_received, ref.doubles_received):
            raise AssertionError(f"{method}/{task}: DOUBLEs differ")
        row = {"method": method, "task": task, "d": width, "steps": n_steps, "device_vs_cpu": err,
               "consensus": float(res.consensus[-1]), "z_max": float(np.max(np.abs(res.z))),
               "doubles_per_node": int(res.doubles_received[-1, 0]),
               "s_device": t_dev, "s_cpu": t_cpu}
        rows.append(row)
        log("solvers", json.dumps(row))
    return rows


def solver_profiles(device, d, k, steps=30) -> list[dict]:
    """``_profile_row`` of every new method with a step of its own, at the
    paper's rcv1 setup (CUDA only)."""
    i_t = torch.as_tensor(np.random.default_rng(0).integers(0, 100, (steps, 10)), device=device)
    rows = []
    for method, task in PROFILED:
        problem = solver_problem(method, task, d, k)
        state0, step, hp_run, _ = bound_step(problem, method, {}, device)

        def run(state=state0, step=step, hp_run=hp_run):
            for t in range(steps):
                state = step(state, i_t[t], hp_run)

        rows.append(_profile_row(f"dense {method} {task}", run, steps))
        del state0, step
        clear_runner_caches()  # the next method's dense features replace these
    return rows


# benchmarks/bench_table1.py's setup: data, graph, eps, and for each method
# its record period (the run is MAX_PASSES periods) and hyperparameters
TABLE1_DATA = dict(n_nodes=6, q=30, d=200, k=8, seed=0)
TABLE1_GRAPH = dict(n=6, p=0.4, seed=1)
TABLE1_EPS = 1e-10
TABLE1_MAX_PASSES = 400
TABLE1_RUNS = {
    "dsba": (30, {"alpha": 1.0}),
    "dsa": (30, {"alpha": 0.15}),
    "extra": (4, {"alpha": 0.3}),
    "mudag": (4, {"eta": 2.0, "momentum": 0.9, "gossip_rounds": 3}),
    "sliding": (4, {"alpha": 0.5, "comm_period": 4}),
    "dsgda": (30, {"alpha": 0.3, "eta": 0.3}),
}
# iterations to dist2 <= eps that bench_table1.py prints (the JAX package);
# None: not within the run. tests/test_torch_table1.py recomputes them
# from the JAX package and holds the port to them.
TABLE1_COUNTS = {
    ("ridge", 1e-1): {"dsba": 690, "dsa": 690, "extra": 340, "mudag": 64, "sliding": 1220},
    ("ridge", 1e-2): {"dsba": 1170, "dsa": 6570, "extra": None, "mudag": 180, "sliding": None},
    ("ridge", 1e-3): {"dsba": 9810, "dsa": None, "extra": None, "mudag": 376, "sliding": None},
    ("bilinear", 1e-2): {"dsba": 1680, "dsa": 6090, "dsgda": 3060},
}


def iters_to_eps(dist2, record_every):
    """bench_table1.py's count: the first record point with dist2 <= eps."""
    idx = int(np.argmax(dist2 <= TABLE1_EPS))
    if dist2[idx] > TABLE1_EPS:
        return None
    return (idx + 1) * record_every


def table1_problem(task, lam):
    """bench_table1.py's problem at ``lam``, with its root (on the CPU)."""
    data = make_regression(**TABLE1_DATA)
    graph = mixing.erdos_renyi_graph(**TABLE1_GRAPH)
    problem = make_problem(task, data, graph, lam=lam)
    problem.solve_star(device="cpu")
    return problem


def table1_count(problem, method, device, stop=None):
    """(iterations to eps or None, launches) of one bench_table1.py run,
    cut at `stop` iterations (a multiple of the record period)."""
    every, hp = TABLE1_RUNS[method]
    steps = min(stop or TABLE1_MAX_PASSES * every, TABLE1_MAX_PASSES * every)
    reset_launches()
    res = solve(problem, method, steps=steps, record_every=every, device=device, **hp)
    return iters_to_eps(res.dist2, every), launches(), steps


def table1_phase(device, counts=TABLE1_COUNTS) -> dict:
    """Every Table-1 count on `device`: each run stops one record period
    past the expected count (or runs whole where it is None), and its count
    must equal it (tests/test_torch_table1.py holds the CPU's counts to the
    same numbers). dsba/dsa launch exactly ``expected_launches`` on the
    card, the other methods none."""
    out = {}
    for (task, lam), want in counts.items():
        problem = table1_problem(task, lam)
        for method, count in want.items():
            stop = None if count is None else count + TABLE1_RUNS[method][0]
            t0 = time.perf_counter()
            c_dev, got, steps = table1_count(problem, method, device, stop)
            t_dev = time.perf_counter() - t0
            if c_dev != count:
                raise AssertionError(f"table1 {task} lam={lam} {method}: device {c_dev}, "
                                     f"reference {count}")
            if device.type == "cuda":
                want_l = expected_launches(steps, "dense") if method in ("dsba", "dsa") else {}
                if got != {**dict.fromkeys(got, 0), **want_l}:
                    raise AssertionError(f"table1 {method}: launches {got} != {want_l}")
            out[f"{task} {lam:g} {method}"] = {"count": c_dev, "steps": steps,
                                               "s_device": t_dev}
            log("table1", f"{task} lam={lam:g} {method}: {c_dev} (device {t_dev:.1f} s, "
                f"{steps} steps)")
    return out


def solvers_run(device) -> dict:
    """``chip_smoke.py --solvers`` (a fresh process): every new method of
    the registry through solve() at the paper's rcv1 width (SSDA cut)
    against the CPU, their steps profiled, and the Table-1 counts."""
    t_all = time.perf_counter()
    log("solvers", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    rcv1 = DATASET_PRESETS["rcv1"]
    out = {}
    t0 = time.perf_counter()
    out["pairs"] = solver_pairs(device, rcv1["d"], rcv1["k"])
    log("solvers", f"pairs done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["profiles"] = solver_profiles(device, rcv1["d"], rcv1["k"])
    log("solvers", f"profiles done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["table1"] = table1_phase(device)
    log("solvers", f"table1 done in {time.perf_counter() - t0:.1f} s")
    out["seconds"] = time.perf_counter() - t_all
    log("solvers", f"all done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 24: dynamic networks, fault injection, checkpoint/resume (--faults)
# ---------------------------------------------------------------------------

# benchmarks/bench_faults.py's iterations to dist2 <= 1e-6 at p = 0 (the JAX
# package); tests/test_torch_faults.py recomputes them from the JAX package
FAULTS_COUNTS = {"dsba": 156, "dsa": 258, "mudag": 48}
FAULTS_HP = {"dsba": {}, "dsa": {}, "mudag": {"eta": 0.5, "momentum": 0.5}}
FAULTS_DROPS = (0.1, 0.2, 0.4)
FAULTS_TOL, FAULTS_STEPS = 1e-6, 300
PLATEAU_RTOL = 1e-10
# the CPU side's steps where the full run is too slow there (a relay step at
# rcv1 width is ~0.1 s on the CPU); the card runs the same solve() at the
# cut length for the comparison, and every cut is logged
FAULTS_CPU_STEPS = {"p0 sparse": 10, "link sparse": 10, "schedule sparse": 35,
                    "churn sparse": 35, "churn mudag": 35, "churn dsgda": 35}
# the checks' lengths: p = 0, link faults and stragglers, schedules and
# churn (their events at a sixth and a third of it, so the CPU side covers
# both in 35 steps); cut from 50, 60 and 180 (events at 60 and 120), and the
# resumes halved, to pay for the --launch process's time
FAULTS_CHECK_STEPS = {"p0": 24, "link": 30, "dynamic": 90}


def faults_graphs(n_nodes=10):
    """The schedule's three segments and the churn plan's join graph."""
    er0 = mixing.erdos_renyi_graph(n_nodes, 0.4, seed=0)
    er1 = mixing.erdos_renyi_graph(n_nodes, 0.4, seed=1)
    # the join graph: the survivor graph after killing node 6, relabeled
    # 0..8, plus the newcomer wired to its seed and one other node
    surv = er0.subgraph([i for i in range(n_nodes) if i != 6])
    joined = mixing.Graph(n_nodes, tuple(sorted(surv.edges + ((0, 9), (4, 9)))))
    if not (er1.is_connected() and joined.is_connected()):
        raise AssertionError("faults graphs are not connected")
    sixth = FAULTS_CHECK_STEPS["dynamic"] // 6
    return ((0, er0), (sixth, mixing.ring_graph(n_nodes)), (2 * sixth, er1)), joined


def faults_launches(method, comm, steps) -> dict[str, int]:
    """dsba/dsa launch as ``expected_launches``; the others launch none."""
    return expected_launches(steps, comm) if method in ("dsba", "dsa") else {}


def fault_check(name, problem, method, comm, device, steps, total, **kw):
    """One solve() on the card held to the same solve() on the CPU: z and
    dist2 within DENSE_TOL_CPU, DOUBLEs, ints and the faults/schedule/
    churn_rows records exactly equal; launches as ``faults_launches``
    predicts. The CPU side runs ``FAULTS_CPU_STEPS[name]`` steps where set
    (the card then runs that length too for the comparison)."""
    cpu = torch.device("cpu")
    reset_launches()
    t0 = time.perf_counter()
    res = solve(problem, method, comm, steps=steps, device=device, **kw)
    t_dev = time.perf_counter() - t0
    got = launches()
    want = faults_launches(method, comm, steps) if device.type == "cuda" else {}
    if got != {**dict.fromkeys(got, 0), **want}:
        raise AssertionError(f"{name}: launches {got} != {want}")
    for k, c in got.items():
        total[k] = total.get(k, 0) + c
    cut = FAULTS_CPU_STEPS.get(name, steps)
    dev_cmp = res if cut == steps else solve(problem, method, comm, steps=cut,
                                             device=device, **kw)
    t0 = time.perf_counter()
    ref = solve(problem, method, comm, steps=cut, device=cpu, **kw)
    t_cpu = time.perf_counter() - t0
    err = float(np.max(np.abs(dev_cmp.z - ref.z)))
    if len(ref.dist2):
        err = max(err, float(np.max(np.abs(dev_cmp.dist2 - ref.dist2))))
    if not np.all(np.isfinite(res.z)) or err > DENSE_TOL_CPU:
        raise AssertionError(f"{name}: card vs CPU {err}")
    for what in ("doubles_received", "ints_received"):
        if not np.array_equal(getattr(dev_cmp, what), getattr(ref, what)):
            raise AssertionError(f"{name}: {what} differ")
    for key in ("faults", "schedule", "churn_rows"):
        if dev_cmp.extras.get(key) != ref.extras.get(key):
            raise AssertionError(f"{name}: extras[{key!r}] differ")
    row = {"check": name, "method": method, "comm": comm, "steps": steps,
           "cpu_steps": cut, "card_vs_cpu": err, "launches": {k: c for k, c in got.items() if c},
           "doubles_per_node": int(res.doubles_received[-1].max()),
           "consensus": float(res.consensus[-1]), "s_card": t_dev, "s_cpu": t_cpu,
           **{k: res.extras[k] for k in ("faults", "churn_rows") if k in res.extras}}
    log("faults", json.dumps(row))
    return res, row


def fault_checks(device, d, k, total) -> list[dict]:
    """Every fault, schedule and churn check of the phase at rcv1 width."""
    alpha = EXPERIMENTS["ridge_rcv1"].alpha
    ridge = paper_problem("ridge", d, k)
    rows = []

    def check(name, method, comm, steps, problem=ridge, **kw):
        if method == "dsba":
            kw.setdefault("alpha", alpha)
        return fault_check(name, problem, method, comm, device, steps, total, **kw)

    link = FaultPlan(link=LinkFault(p=0.1, seed=7))
    strag = FaultPlan(straggler=StragglerSpec(p=0.2, max_staleness=2, seed=3))
    both = FaultPlan(link=LinkFault(p=0.1, seed=7),
                     straggler=StragglerSpec(p=0.2, max_staleness=2, seed=3))
    # p = 0 is bit-equal to a plan-free run, with the same launches
    n_p0, n_link, n_dyn = (FAULTS_CHECK_STEPS[k] for k in ("p0", "link", "dynamic"))
    for comm in ("dense", "sparse"):
        plain, row = check(f"p0 {comm}", "dsba", comm, n_p0, record_every=n_p0 // 2)
        zero, _ = check(f"p0 {comm}", "dsba", comm, n_p0, record_every=n_p0 // 2,
                        comm_options={"fault_plan": FaultPlan(link=LinkFault(p=0.0))})
        same = (np.array_equal(plain.z, zero.z) and np.array_equal(plain.consensus, zero.consensus)
                and np.array_equal(plain.doubles_received, zero.doubles_received))
        if not same or zero.extras["faults"]["drop_rate"] != 0.0:
            raise AssertionError(f"p0 {comm}: not bit-equal to the plan-free run")
        rows.append(row)
    for name, method, plan, kw in (
        ("link dsba", "dsba", link, {}), ("link dsa", "dsa", link, {}),
        ("straggler dsba", "dsba", strag, {}), ("link+straggler dsba", "dsba", both, {}),
        ("link mudag", "mudag", link, FAULTS_HP["mudag"]),
    ):
        rows.append(check(name, method, "dense", n_link, record_every=n_link // 2,
                          comm_options={"fault_plan": plan}, **kw)[1])
    rows.append(check("link sparse", "dsba", "sparse", n_link, record_every=5,
                      comm_options={"fault_plan": link})[1])
    schedule, joined = faults_graphs()
    sched = dataclasses.replace(ridge, schedule=schedule)
    for comm in ("dense", "sparse"):
        rows.append(check(f"schedule {comm}", "dsba", comm, n_dyn, problem=sched,
                          record_every=5 if comm == "sparse" else n_dyn // 6)[1])
    # kill the degree-6 hub at a sixth; at a third one node joins, seeded
    # from node 0
    churn = FaultPlan(churn=ChurnPlan((
        ChurnEvent(at=n_dyn // 6, kind="kill", nodes=(6,)),
        ChurnEvent(at=n_dyn // 3, kind="join", n_new=1, seed_from=0, graph=joined))))
    auc = paper_problem("auc", d, k)
    for name, method, comm, problem, kw in (
        ("churn dense", "dsba", "dense", ridge, {}),
        ("churn sparse", "dsba", "sparse", ridge, {}),
        ("churn mudag", "mudag", "dense", ridge, FAULTS_HP["mudag"]),
        ("churn dsgda", "dsgda", "dense", auc, {}),
    ):
        rows.append(check(name, method, comm, n_dyn, problem=problem, record_every=5,
                          comm_options={"fault_plan": churn}, **kw)[1])
    return rows


def tree_bytes(path) -> int:
    """Bytes of the files under `path`."""
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def resume_check(device, d, k, comm, steps, every, stop, total) -> dict:
    """``solve(checkpoint=)`` stopped at `stop`, then ``solve(resume=)`` to
    `steps`, bit-equal to the uninterrupted card run in z, dist2/consensus
    and the counts; the bytes and seconds of one save and one restore."""
    problem = paper_problem("ridge", d, k)
    kw = dict(record_every=every, seed=3, alpha=EXPERIMENTS["ridge_rcv1"].alpha)
    full = counted_solve(problem, "dsba", comm, device, steps, total, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        ck = Path(tmp) / "ck"
        t0 = time.perf_counter()
        counted_solve(problem, "dsba", comm, device, stop, total,
                      checkpoint=CheckpointSpec(ck, every=every), **kw)
        t_first = time.perf_counter() - t0
        if committed_steps(ck) != list(range(every, stop + 1, every)):
            raise AssertionError(f"{comm} checkpoints {committed_steps(ck)}")
        reset_launches()
        t0 = time.perf_counter()
        res = solve(problem, "dsba", comm, steps=steps, device=device, resume=str(ck), **kw)
        t_resume = time.perf_counter() - t0
        got = launches()
        want = expected_launches(steps - stop, comm) if device.type == "cuda" else {}
        if got != {**dict.fromkeys(got, 0), **want}:
            raise AssertionError(f"resume {comm}: launches {got} != {want}")
        for name, c in got.items():
            total[name] = total.get(name, 0) + c
        for what in ("z", "dist2", "consensus", "iters", "doubles_received", "ints_received"):
            if not np.array_equal(getattr(full, what), getattr(res, what)):
                raise AssertionError(f"resume {comm}: {what} is not bit-equal")
        nbytes = tree_bytes(ck / f"step_{stop}")
        t0 = time.perf_counter()
        step_r, meta, leaves = load_checkpoint(ck)
        t_read = time.perf_counter() - t0
        dev_tree = {p: torch.as_tensor(a, device=device) for p, a in leaves.items()}
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        CheckpointManager(Path(tmp) / "again").save(step_r, dev_tree, metadata=meta, async_=False)
        t_save = time.perf_counter() - t0
    out = {"comm": comm, "steps": steps, "every": every, "stopped_at": stop, "bit_equal": True,
           "checkpoint_bytes": nbytes, "save_s": t_save, "restore_read_s": t_read,
           "s_checkpointed_run": t_first, "s_resumed_run": t_resume,
           "resume_launches": {k: c for k, c in got.items() if c}}
    log("faults", json.dumps(out))
    return out


def faults_curve(device) -> dict:
    """benchmarks/bench_faults.py's curve (ring of 8, lam 1e-2, 300 steps,
    record_every=1, seed 1, LinkFault(p, seed=7)) on the card and the CPU:
    the p = 0 counts equal ``FAULTS_COUNTS``, the last-quarter median
    plateaus for p > 0 agree within PLATEAU_RTOL."""
    cpu = torch.device("cpu")
    problem = make_problem("ridge", make_regression(8, 12, 6, k=3, seed=0),
                           mixing.ring_graph(8), lam=1e-2)
    problem.solve_star(device="cpu")
    out = {}
    for method, hp in FAULTS_HP.items():
        for p in (0.0, *FAULTS_DROPS):
            opts = {"fault_plan": FaultPlan(link=LinkFault(p=p, seed=7))} if p else None
            got = []
            for dev in (device, cpu):
                res = solve(problem, method, steps=FAULTS_STEPS, record_every=1, seed=1,
                            comm_options=opts, device=dev, **hp)
                hit = np.flatnonzero(res.dist2 <= FAULTS_TOL)
                got.append((int(hit[0]) + 1 if hit.size else None,
                            float(np.median(res.dist2[-(FAULTS_STEPS // 4):]))))
            (c_dev, pl_dev), (c_cpu, pl_cpu) = got
            if p == 0.0 and not c_dev == c_cpu == FAULTS_COUNTS[method]:
                raise AssertionError(f"faults curve {method}: card {c_dev}, CPU {c_cpu}, "
                                     f"reference {FAULTS_COUNTS[method]}")
            if p and abs(pl_dev - pl_cpu) > PLATEAU_RTOL * abs(pl_cpu):
                raise AssertionError(f"faults curve {method} p={p}: plateau {pl_dev} vs {pl_cpu}")
            out[f"{method} p={p:g}"] = {"iters_to_1e-6": c_dev, "plateau": pl_dev,
                                        "plateau_cpu": pl_cpu}
    log("faults", "bench_faults curve: " + json.dumps(out))
    return out


def fault_profiles(device, d, k, steps=10) -> list[dict]:
    """``_profile_row`` of the dense dsba step plain, with the link mask and
    with stragglers (the step alone: its comm, masks and state built
    before), and of the relay solve with and without a sent_mask (setup
    included), at rcv1 width."""
    problem = paper_problem("ridge", d, k)
    hp = {"alpha": EXPERIMENTS["ridge_rcv1"].alpha}
    i_t = torch.as_tensor(np.random.default_rng(0).integers(0, 100, (steps, 10)), device=device)
    link = link_delivered_mask(LinkFault(p=0.1, seed=7), problem.graph, steps)
    strag = straggler_delivered_mask(StragglerSpec(p=0.2, max_staleness=2, seed=3), 10, steps)
    rows = []
    for name, lm, sm in (("plain", None, None), ("link mask", link, None),
                         ("stragglers", None, strag)):
        state0, step, hp_run, comm = bound_step(problem, "dsba", hp, device, lm, sm)
        rows.append(_profile_row(
            f"dense dsba ridge, {name}",
            lambda state0=state0, step=step, comm=comm, hp_run=hp_run: _advance(
                state0, step, comm, i_t, 0, steps, hp_run), steps))
    plan = {"fault_plan": FaultPlan(link=LinkFault(p=0.1, seed=7))}
    for name, opts in (("plain", None), ("sent_mask", plan)):
        rows.append(_profile_row(
            f"relay dsba ridge, {name} (whole solve incl. setup)",
            lambda opts=opts: solve(problem, "dsba", "sparse", steps=steps, device=device,
                                    comm_options=opts, **hp),
            steps))
    return rows


def faults_run(device) -> dict:
    """``chip_smoke.py --faults`` (a fresh process): faults, schedules, churn
    and checkpoint/resume through solve() at the paper's rcv1 Section-7
    setup against the CPU, bench_faults' curve, and the profiles. Its
    launches join the kernels line."""
    t_all = time.perf_counter()
    log("faults", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    log("faults", f"CPU-side cuts (steps): {json.dumps(FAULTS_CPU_STEPS)}")
    rcv1 = DATASET_PRESETS["rcv1"]
    total: dict[str, int] = {}
    out = {}
    for part, fn in (
        ("checks", lambda: fault_checks(device, rcv1["d"], rcv1["k"], total)),
        ("resume", lambda: [
            resume_check(device, rcv1["d"], rcv1["k"], "dense", 100, 25, 50, total),
            resume_check(device, rcv1["d"], rcv1["k"], "sparse", 50, 25, 25, total)]),
        ("curve", lambda: faults_curve(device)),
        ("profiles", lambda: fault_profiles(device, rcv1["d"], rcv1["k"])),
    ):
        t0 = time.perf_counter()
        out[part] = fn()
        log("faults", f"{part} done in {time.perf_counter() - t0:.1f} s")
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_all
    log("faults", f"launches {total}; all done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 25: hyperparameter sweeps as one batched computation (--sweep)
# ---------------------------------------------------------------------------

# benchmarks/bench_convergence.py's tune_stochastic grid (dsba, ridge)
SWEEP_ALPHAS = (0.5, 1.0, 2.0, 4.0, 8.0)
SWEEP_DSA_ALPHAS = (0.05, 0.1, 0.2)
SWEEP_RELAY_ALPHAS = (0.5, 1.0, 2.0)
SWEEP_EXTRA_ALPHAS = (0.2, 0.3)
SWEEP_K = (2.0, 5.0)  # Mudag's K grid (tests/test_accel_minimax.py)


def _grid_check(name, problem, method, grid, device, steps, record_every, total,
                cpu_too=True, bar=DENSE_TOL_CPU):
    """``solve_many`` over ``grid`` on `device` against one ``solve()`` an
    entry on `device`: bit-equal for dsba/dsa (else within ``bar``), DOUBLEs
    equal; with ``cpu_too`` the same sweep on the CPU within DENSE_TOL_CPU.
    dsba/dsa launch ``expected_launches`` once for the whole grid."""
    reset_launches()
    t0 = time.perf_counter()
    many = solve_many(problem, method, steps=steps, record_every=record_every, grid=grid,
                      device=device)
    t_many = time.perf_counter() - t0
    got = launches()
    for k_, c in got.items():
        total[k_] = total.get(k_, 0) + c
    if device.type == "cuda":
        want = expected_launches(steps, "dense") if method in ("dsba", "dsa") else {}
        if got != {**dict.fromkeys(got, 0), **want}:
            raise AssertionError(f"{name}: launches {got} != {want}")
    if not (many.extras["batched"] and np.all(np.isfinite(many.z))):
        raise AssertionError(f"{name}: not batched, or non-finite iterates")
    t0 = time.perf_counter()
    seq = [solve(problem, method, steps=steps, record_every=record_every, device=device, **g)
           for g in grid]
    t_seq = time.perf_counter() - t0
    bit = all(np.array_equal(many.z[b], r.z) and np.array_equal(many.consensus[b], r.consensus)
              for b, r in enumerate(seq))
    err = max(float(np.max(np.abs(many.z[b] - r.z))) for b, r in enumerate(seq))
    if method in ("dsba", "dsa") and not bit:
        raise AssertionError(f"{name}: batched != sequential (max {err})")
    if err > bar:
        raise AssertionError(f"{name}: batched vs sequential {err}")
    if not all(np.array_equal(many.doubles_received[b], r.doubles_received)
               for b, r in enumerate(seq)):
        raise AssertionError(f"{name}: DOUBLEs differ")
    row = {"check": name, "B": len(grid), "steps": steps, "bit_equal": bit, "max_err": err,
           "launches": {k_: c for k_, c in got.items() if c},
           "s_batched": t_many, "s_sequential": t_seq}
    if cpu_too:
        t0 = time.perf_counter()
        ref = solve_many(problem, method, steps=steps, record_every=record_every, grid=grid,
                         device=torch.device("cpu"))
        row["s_cpu"] = time.perf_counter() - t0
        row["card_vs_cpu"] = float(np.max(np.abs(many.z - ref.z)))
        if row["card_vs_cpu"] > DENSE_TOL_CPU:
            raise AssertionError(f"{name}: card vs CPU {row['card_vs_cpu']}")
    log("sweep", json.dumps(row))
    return row


def _relay_check(problem, device, steps, total) -> dict:
    """``run_sparse_many`` on ``SWEEP_RELAY_ALPHAS`` against one
    ``run_sparse`` an alpha (the same streams), bit for bit; its launches
    (one run's, plus one densify a step) and its device memory a run."""
    alphas = SWEEP_RELAY_ALPHAS
    b, n = len(alphas), problem.graph.n
    idx = np.stack([draw_indices(steps, n, problem.data.q, s) for s in range(b)])
    cfg = DSBAConfig(problem.spec, 0.0, problem.lam)
    sync = device.type == "cuda"
    if sync:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if sync else 0
    reset_launches()
    t0 = time.perf_counter()
    many = run_sparse_many(cfg, problem.data, problem.graph, problem.w, steps, idx, alphas,
                           device=device)
    t_many = time.perf_counter() - t0
    got = launches()
    peak = torch.cuda.max_memory_allocated() if sync else 0
    for k_, c in got.items():
        total[k_] = total.get(k_, 0) + c
    if sync:
        want = {"sparse_dot": steps, "sparse_axpy": 1 + 5 * steps}
        if got != {**dict.fromkeys(got, 0), **want}:
            raise AssertionError(f"relay sweep: launches {got} != {want}")
    t0 = time.perf_counter()
    seq = [run_sparse(dataclasses.replace(cfg, alpha=a), problem.data, problem.graph,
                      problem.w, steps, idx[i], device=device) for i, a in enumerate(alphas)]
    t_seq = time.perf_counter() - t0
    for i, r in enumerate(seq):
        if not (np.array_equal(many[i].z_trace, r.z_trace)
                and np.array_equal(many[i].doubles_received, r.doubles_received)
                and np.array_equal(many[i].ints_received, r.ints_received)):
            raise AssertionError(f"relay sweep: run {i} != its run_sparse")
    depth = max(3, problem.graph.diameter + 2)
    ring = depth * n * n * problem.dim * problem.data.val.itemsize
    per_run = (peak - base) / b if sync else 0.0
    free = torch.cuda.mem_get_info()[0] if sync else 0
    row = {"check": "relay run_sparse_many", "B": b, "steps": steps, "bit_equal": True,
           "launches": {k_: c for k_, c in got.items() if c}, "s_batched": t_many,
           "s_sequential": t_seq, "ring_bytes_a_run": ring, "peak_bytes_a_run": per_run,
           "free_bytes_after": free,
           "max_B_in_free_memory": int(free // per_run) if per_run else None}
    log("sweep", json.dumps(row))
    return row


def sweep_checks(device, d, k, n_nodes=10, q=100, steps=40, record_every=20,
                 total=None) -> dict:
    """Every check of the sweep phase on one problem (the rcv1 Section-7
    setup on the card): the 5-alpha dsba and the 3-alpha dsa grids bit-equal
    to sequential runs and within DENSE_TOL_CPU of the CPU; the relay sweep
    bit-equal to run_sparse; EXTRA and Mudag's K grid within DENSE_TOL_CPU
    of sequential runs; both sparse kernels held to their plain versions
    during batched steps at B*N rows; a second alpha on a warm runner adds
    one hit and no trace."""
    total = {} if total is None else total
    ridge = paper_problem("ridge", d, k, n_nodes, q)
    out = {}
    kw = dict(device=device, steps=steps, record_every=record_every, total=total)
    out["dsba_grid"] = _grid_check("dsba 5-alpha grid", ridge, "dsba",
                                   [{"alpha": a} for a in SWEEP_ALPHAS], **kw)
    out["dsa_grid"] = _grid_check("dsa 3-alpha grid", ridge, "dsa",
                                  [{"alpha": a} for a in SWEEP_DSA_ALPHAS], **kw)
    out["relay"] = _relay_check(ridge, device, max(6, steps // 2), total)
    short = dict(kw, steps=max(4, steps // 2), record_every=max(2, record_every // 2),
                 cpu_too=False)
    out["extra"] = _grid_check("extra 2-alpha grid", ridge, "extra",
                               [{"alpha": a} for a in SWEEP_EXTRA_ALPHAS], **short)
    out["mudag"] = _grid_check("mudag K grid", ridge, "mudag",
                               [{"gossip_rounds": g} for g in SWEEP_K], **short)
    out["held"] = _held_batched_steps(ridge, device)
    clear_runner_caches()
    solve(ridge, "dsba", steps=2, record_every=2, device=device, alpha=SWEEP_ALPHAS[0])
    s0 = runner_cache_stats()["dense"]
    solve(ridge, "dsba", steps=2, record_every=2, device=device, alpha=SWEEP_ALPHAS[1])
    s1 = runner_cache_stats()["dense"]
    out["cache"] = {"new_traces": s1["traces"] - s0["traces"], "new_hits": s1["hits"] - s0["hits"]}
    if out["cache"] != {"new_traces": 0, "new_hits": 1} or s1["misses"] != s0["misses"]:
        raise AssertionError(f"a second alpha: stats {s0} -> {s1}")
    log("sweep", f"a second alpha on a warm runner: {json.dumps(out['cache'])}")
    return out


def _held_batched_steps(problem, device) -> dict:
    """Two batched dsba steps (t = 0 and t = 1) of the 5-alpha grid with
    every sparse_dot and sparse_axpy call held to its plain version on its
    own B*N-row inputs (float64 sparse_axpy bit for bit)."""
    spec = get_solver("dsba")
    hp = dict(spec.defaults)
    runner = _get_dense_runner(spec, problem, hp, device)
    merged = [{"alpha": a} for a in SWEEP_ALPHAS]
    hp_b = _dynamic_hp(spec, problem, hp, runner.data.val.dtype, device, merged=merged)
    b, n = len(merged), problem.graph.n
    state = batch_tree(runner.init(torch.zeros((n, problem.dim), dtype=runner.data.val.dtype,
                                               device=device)), b)
    idx = torch.as_tensor(np.stack([draw_indices(2, n, problem.data.q, s) for s in range(b)]),
                          dtype=torch.long, device=device)
    with ops.held_to_plain("sparse_dot") as e_dot, ops.held_to_plain("sparse_axpy") as e_axpy:
        for t in range(2):
            state = runner.step(state, idx[:, t], hp_b)
        if device.type == "cuda":
            torch.cuda.synchronize()
    if len(e_dot) != 2 or len(e_axpy) != 8 or not all(e_axpy.exact):
        raise AssertionError(f"held batched steps: {len(e_dot)} dot and {len(e_axpy)} axpy "
                             f"calls, axpy exact {list(e_axpy.exact)}")
    row = {"rows": b * n, "D": problem.dim, "sparse_dot_calls": len(e_dot),
           "sparse_axpy_calls": len(e_axpy), "sparse_dot_max_abs_err": max(e_dot),
           "sparse_axpy_max_abs_err": max(e_axpy), "sparse_axpy_bit_equal": True}
    log("sweep", f"held batched steps: {json.dumps(row)}")
    return row


def mixing_variants(device, n, d, b) -> dict:
    """The mixing product of a (B, N, D) batch three ways at the sweep's
    shape: B same-shape products (what ``DenseComm`` does), one broadcast
    batched product, and one (N, B*D) product: ms each (CUDA events) and
    whether each is bit-equal to the first."""
    g = torch.Generator(device=device).manual_seed(0)
    w = torch.rand((n, n), generator=g, dtype=torch.float64, device=device)
    x = torch.randn((b, n, d), generator=g, dtype=torch.float64, device=device)

    def loop():
        out = torch.empty_like(x)
        for i in range(b):
            torch.matmul(w, x[i], out=out[i])
        return out

    def wide():
        return (w @ x.transpose(0, 1).reshape(n, b * d)).reshape(n, b, d).transpose(0, 1)

    ref = loop()
    out = {}
    for name, fn in (("loop", loop), ("broadcast", lambda: w @ x), ("wide", wide)):
        out[name] = {"ms": cuda_ms(fn, iters=100, warmup=10), "bit_equal": torch.equal(fn(), ref)}
    log("sweep", f"mixing a (B={b}, N={n}, D={d}) batch: {json.dumps(out)}")
    return out


def sweep_profile(device, d, k, steps=30) -> dict:
    """The 5-alpha grid's step alone (the bound batched step, as
    ``profile_steps`` times one run's) against one run's step, then the
    grid as one warm ``solve_many`` against five warm ``solve()`` calls and
    one (whole calls: setup, the record point, the host copy of z and the
    host's metrics included): wall ms, device-busy ms and launches per step
    (a grid or five runs of a step), idle share."""
    problem = paper_problem("ridge", d, k)
    grid = [{"alpha": a} for a in SWEEP_ALPHAS]
    b = len(grid)
    i_t = torch.as_tensor(np.random.default_rng(0).integers(0, 100, (steps, b, 10)),
                          device=device)
    state1, step1, hp1, _ = bound_step(problem, "dsba", grid[0], device)
    state_b, step_b, hp_b, _ = bound_step(problem, "dsba", grid[0], device, merged=grid)

    def run_one():
        state = state1
        for t in range(steps):
            state = step1(state, i_t[t, 0], hp1)

    def run_grid():
        state = state_b
        for t in range(steps):
            state = step_b(state, i_t[t], hp_b)

    kw = dict(steps=steps, record_every=steps, device=device)
    rows = {
        "grid_step": _profile_row(f"dsba ridge {b}-alpha grid, the batched step alone",
                                  run_grid, steps),
        "one_step": _profile_row("dsba ridge one run, the step alone", run_one, steps),
        "grid": _profile_row(f"dsba ridge {len(grid)}-alpha grid, one solve_many (warm)",
                             lambda: solve_many(problem, "dsba", grid=grid, **kw), steps),
        "sequential": _profile_row(
            f"dsba ridge {len(grid)} solve() calls, one an alpha (warm)",
            lambda: [solve(problem, "dsba", **kw, **g) for g in grid], steps),
        "one": _profile_row("dsba ridge one solve() (warm)",
                            lambda: solve(problem, "dsba", **kw, **grid[0]), steps),
    }
    return rows


def cold_warm(device, d, k, steps=10) -> dict:
    """Seconds of a ``solve()`` on an empty runner cache and of the next one
    on the same problem with a new hyperparameter value (warm), for dsba
    (dense and relay) and EXTRA (378 MB of dense features at rcv1 width)."""
    problem = paper_problem("ridge", d, k)
    out = {}
    for name, method, comm, hp1, hp2 in (
        ("dsba dense", "dsba", "dense", {"alpha": 0.5}, {"alpha": 1.0}),
        ("dsba relay", "dsba", "sparse", {"alpha": 0.5}, {"alpha": 1.0}),
        ("extra dense", "extra", "dense", {"alpha": 0.2}, {"alpha": 0.3}),
    ):
        clear_runner_caches()
        gc.collect()
        torch.cuda.synchronize()
        times = []
        for hp in (hp1, hp2):
            t0 = time.perf_counter()
            solve(problem, method, comm, steps=steps, record_every=steps, device=device, **hp)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = {"steps": steps, "cold_s": times[0], "warm_s": times[1]}
    log("sweep", f"cold vs warm solve(): {json.dumps(out)}")
    return out


def sweep_run(device) -> dict:
    """``chip_smoke.py --sweep`` (a fresh process): ``solve_many`` and
    ``run_sparse_many`` at the rcv1 Section-7 setup (``sweep_checks``),
    the kernels at B*N rows, the mixing variants, the grid's profile
    against sequential runs, cold vs warm ``solve()``; and clearing the
    runner caches returns the card's allocated memory to its level before
    the phase. Its launches join the kernels line."""
    t_all = time.perf_counter()
    log("sweep", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    rcv1 = DATASET_PRESETS["rcv1"]
    d, k = rcv1["d"], rcv1["k"]
    # the cuBLAS workspace is made at the first product and kept: make it
    # before the memory baseline
    torch.ones((10, 10), dtype=torch.float64, device=device) @ torch.ones(
        (10, 4), dtype=torch.float64, device=device)
    clear_runner_caches()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    total: dict[str, int] = {}
    out = {}
    for part, fn in (
        ("checks", lambda: sweep_checks(device, d, k, total=total)),
        ("kernels_bn", lambda: time_kernels(device, 10 * len(SWEEP_ALPHAS), d, k)),
        ("mixing", lambda: mixing_variants(device, 10, d, len(SWEEP_ALPHAS))),
        ("profile", lambda: sweep_profile(device, d, k)),
        ("cold_warm", lambda: cold_warm(device, d, k)),
    ):
        t0 = time.perf_counter()
        out[part] = fn()
        log("sweep", f"{part} done in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    clear_runner_caches()
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    out["memory"] = {"before": base, "with_cache": held, "after_clear": after}
    log("sweep", f"allocated bytes: before the phase {base}, with the runner cache {held}, "
        f"after clear() {after}")
    if after != base:
        raise AssertionError(f"clear() left {after - base} bytes allocated")
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_all
    log("sweep", f"launches {total}; all done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 26: the examples, the public entry points, the meta-device dry run and
# the kernel build cache (--launch)
# ---------------------------------------------------------------------------

SOLVER_KERNELS = ("sparse_dot", "sparse_axpy")
# the examples' lengths on the card (their defaults: quickstart 8,000 steps,
# decentralized_ridge 40 passes, auc_maximization 30): every held
# sparse_axpy call runs the plain version's k-column scatter beside the
# kernel (8,000 held quickstart steps took 60 s)
QUICKSTART_STEPS = 200
RIDGE_PASSES = 2
AUC_PASSES = 4


def held_run(names, fn):
    """``fn()`` with every call of the kernels `names` held to its plain
    version; (its result, {name: HeldCalls}, the launches it made)."""
    reset_launches()
    with contextlib.ExitStack() as stack:
        held = {n: stack.enter_context(ops.held_to_plain(n)) for n in names}
        out = fn()
    torch.cuda.synchronize()
    return out, held, launches()


def launch_examples(device) -> dict:
    """The four examples' ``main()`` on the card, every kernel call held to
    its plain version: quickstart (``QUICKSTART_STEPS``), decentralized_ridge
    at rcv1's published width (d = 47,236, k = 74; ``RIDGE_PASSES``),
    auc_maximization (``AUC_PASSES``), serve_decode for mamba2-1.3b
    (reduced; its prefill runs ssd_chunk)."""
    rcv1 = DATASET_PRESETS["rcv1"]
    runs = {
        "quickstart": (SOLVER_KERNELS, lambda: quickstart.main(
            steps=QUICKSTART_STEPS, record_every=QUICKSTART_STEPS // 4, device=device)),
        "decentralized_ridge": (SOLVER_KERNELS, lambda: decentralized_ridge.main(
            ["--dataset", "rcv1", "--d", str(rcv1["d"]), "--passes", str(RIDGE_PASSES)],
            device=device)),
        "auc_maximization": (SOLVER_KERNELS, lambda: auc_maximization.main(
            passes=AUC_PASSES, device=device)),
        "serve_decode": (("ssd_chunk",), lambda: serve_decode.main(
            ["--arch", "mamba2-1.3b"], device=device)),
    }
    out, total = {}, {}
    for name, (kernels, fn) in runs.items():
        t0 = time.perf_counter()
        res, held, got = held_run(kernels, fn)
        seconds = time.perf_counter() - t0
        for k in kernels:
            if got[k] == 0 or len(held[k]) != got[k]:
                raise AssertionError(f"{name}: {got[k]} {k} launches, {len(held[k])} held calls")
        curves = ([res.dist2] if name != "decentralized_ridge"
                  else [d2 for _, d2 in res.values()]) if res is not None else []
        if not all(np.all(np.isfinite(c)) and len(c) for c in curves):
            raise AssertionError(f"{name}: a non-finite or empty dist2 curve")
        out[name] = {"s": seconds, "launches": {k: c for k, c in got.items() if c},
                     "max_abs_err": {k: max(held[k]) for k in kernels},
                     "exact": {k: all(held[k].exact) for k in kernels}}
        if name == "decentralized_ridge":
            out[name]["final_dist2"] = {m: float(d2[-1]) for m, (_, d2) in res.items()}
        log("launch", f"example {name}: {json.dumps(out[name])}")
        for k, c in got.items():
            total[k] = total.get(k, 0) + c
    return {"runs": out, "launches": total}


def _on_off(name, on, off, tol) -> float:
    """Hold mode 'on' outputs (a tensor or tuple) to mode 'off' ones."""
    pairs = zip(on, off) if isinstance(on, tuple) else [(on, off)]
    err = max(ops.assert_close(a.detach(), b.detach(), tol) for a, b in pairs)
    log("launch", f"entry {name}: on vs off max abs err {err!r}")
    return err


def launch_entries(device) -> dict:
    """The six public entry points of the registry, mode 'on' (the CUDA
    kernel) against 'off' (the plain version) on the same inputs at small
    shapes, within the registry's tolerance; gradients for flash_attention
    and ssd_chunk within its gradient tolerance. The SSD's plain side runs
    in float64, the registry's ``plain_dtype``."""
    g = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)

    errs = {}
    spec = ops.get_kernel("flash_attention")
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = rnd(2, 4, 96, 64, dtype=dtype), rnd(2, 2, 96, 64, dtype=dtype), \
            rnd(2, 2, 96, 64, dtype=dtype)
        do = rnd(2, 4, 96, 64, dtype=dtype)
        for kw in (dict(causal=True), dict(causal=False, window=32, softcap=20.0)):
            outs, grads = {}, {}
            for mode in ("on", "off"):
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                outs[mode] = ops.flash_attention(*leaves, mode=mode, **kw)
                grads[mode] = torch.autograd.grad(outs[mode], leaves, do)
            tag = f"flash_attention {dtype} {kw}"
            errs[tag] = _on_off(tag, outs["on"], outs["off"], spec.tolerance(dtype))
            errs[tag + " grad"] = _on_off(tag + " grad", tuple(grads["on"]),
                                          tuple(grads["off"]), spec.grad_tolerance(dtype))
    bs, n_pages, lengths = 16, 4, torch.tensor([1, 40, 64], dtype=torch.int32, device=device)
    pool = (rnd(3 * n_pages + 1, bs, 2, 64, dtype=torch.bfloat16),
            rnd(3 * n_pages + 1, bs, 2, 64, dtype=torch.bfloat16))
    table = torch.arange(1, 3 * n_pages + 1, dtype=torch.int32, device=device).reshape(3, -1)
    dargs = (rnd(3, 8, 64, dtype=torch.bfloat16), *pool, table, lengths)
    errs["decode_attention"] = _on_off(
        "decode_attention", ops.decode_attention(*dargs, mode="on", softcap=30.0),
        ops.decode_attention(*dargs, mode="off", softcap=30.0),
        ops.get_kernel("decode_attention").tolerance(torch.bfloat16))
    psi, idx, val, coef, rho = kernel_inputs(10, 1000, 9, torch.float64, device, dups=False)
    errs["saga_sparse_dot"] = _on_off(
        "saga_sparse_dot", ops.saga_sparse_dot(psi, idx, val, mode="on"),
        ops.saga_sparse_dot(psi, idx, val, mode="off"),
        ops.get_kernel("sparse_dot").tolerance(torch.float64))
    errs["saga_sparse_axpy"] = _on_off(
        "saga_sparse_axpy", ops.saga_sparse_axpy(psi, idx, val, coef, rho, mode="on"),
        ops.saga_sparse_axpy(psi, idx, val, coef, rho, mode="off"),
        ops.get_kernel("sparse_axpy").tolerance(torch.float64))
    x = rnd(64, 512)
    tspec = ops.get_kernel("block_topk")
    errs["topk_blocks"] = tspec.compare((x, 8), ops.topk_blocks(x, 8, mode="on"),
                                        ops.topk_blocks(x, 8, mode="off"),
                                        tspec.tolerance(torch.float32))
    log("launch", f"entry topk_blocks: on vs off {errs['topk_blocks']!r}")
    args, cts = ssd_inputs((1, 2, 64, 4, 32, 16), device)
    sspec = ops.get_kernel("ssd_chunk")
    outs, grads = {}, {}
    for mode, dtype in (("on", torch.float32), ("off", torch.float64)):
        leaves = [t.detach().to(dtype).requires_grad_() for t in args]
        outs[mode] = ops.ssd_chunk(*leaves, mode=mode)
        grads[mode] = torch.autograd.grad(outs[mode], leaves, [c.to(dtype) for c in cts])
    errs["ssd_chunk"] = _on_off("ssd_chunk", outs["on"], outs["off"],
                                sspec.tolerance(torch.float32))
    errs["ssd_chunk grad"] = _on_off("ssd_chunk grad", tuple(grads["on"]), tuple(grads["off"]),
                                     sspec.grad_tolerance(torch.float32))
    return errs


LAUNCH_CELLS = (("minitron-8b", "train_4k"), ("mamba2-1.3b", "long_500k"),
                ("zamba2-1.2b", "decode_32k"), ("qwen2-moe-a2.7b", "prefill_32k"),
                ("whisper-small", "train_4k"))
# the cell that fits the card: minitron-8b cut to 4 layers, train_4k's 256
# rows cut to 1
FIT_LAYERS = 4
FIT_SHAPE = ShapeSpec("train_4k_b1", "train", 4096, 1)


def _dry_summary(rec) -> dict:
    rl = rec["roofline"]
    return {"tflop": rec["hlo_flops"] / 1e12, "gbytes": rec["hlo_bytes"] / 1e9,
            "peak_gb": rec["memory"]["peak_bytes"] / 1e9, "fits_one_card": rec["fits_one_card"],
            "compute_s": rl["compute_s"], "memory_s": rl["memory_s"], "dominant": rl["dominant"],
            "useful_flop_ratio": rl["useful_flop_ratio"], "count_s": rec["count_s"],
            "kernels": {op: r["calls"] for op, r in rec["op_table"].items()
                        if op.startswith("kernel:")}}


def launch_dryrun(device) -> dict:
    """The dry run on this CUDA machine: the five full-config cells on the
    meta device (no kernel may launch: a kernel wrapper decides by its
    tensor's device, and these are meta), then the fitting cell both on
    meta and for real on the card: the counted peak beside
    ``torch.cuda.max_memory_allocated()``, the argument bytes beside the
    card's allocation before the step, the counted kernel calls beside the
    card's launches, the counted FLOPs beside ``model_flops``."""
    out = {}
    reset_launches()
    for arch, shape in LAUNCH_CELLS:
        rec = dryrun.run_cell(arch, shape)
        if not rec["ok"]:
            raise AssertionError(f"dry run {arch} {shape}: {rec['error']}\n{rec['traceback']}")
        out[f"{arch} {shape}"] = _dry_summary(rec)
        log("launch", f"dry run {arch} {shape}: {json.dumps(out[f'{arch} {shape}'])}")
    if any(launches().values()):
        raise AssertionError(f"the dry run launched kernels: {launches()}")
    cfg = dataclasses.replace(get_config("minitron-8b"), n_layers=FIT_LAYERS)
    fn, args = dryrun.build_cell(cfg, FIT_SHAPE, "meta")
    _, costs = count_step(fn, *args)
    del fn, args
    gc.collect()
    torch.cuda.empty_cache()
    fn, args = dryrun.build_cell(cfg, FIT_SHAPE, device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    _, metrics = fn(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak, got = torch.cuda.max_memory_allocated(), launches()
    loss = float(metrics["loss"])
    del fn, args, metrics
    gc.collect()
    torch.cuda.empty_cache()
    counted = {k.removeprefix("kernel:"): r.calls for k, r in costs.table.items()
               if k.startswith("kernel:")}
    # flash_attention_bwd launches two kernels a call
    want = {"flash_attention": counted["flash_attention"],
            "flash_attention_bwd": 2 * counted["flash_attention_bwd"]}
    if {k: got[k] for k in want} != want or not math.isfinite(loss):
        raise AssertionError(f"fitting cell: launches {got}, counted calls {counted}, "
                             f"loss {loss}")
    mf = model_flops(cfg, FIT_SHAPE.kind, FIT_SHAPE.batch, FIT_SHAPE.seq)
    fit = {"arch": "minitron-8b", "layers": FIT_LAYERS, "batch": FIT_SHAPE.batch,
           "seq": FIT_SHAPE.seq, "meta_peak_gb": costs.peak_bytes / 1e9,
           "card_peak_gb": peak / 1e9, "card_over_meta_peak": peak / costs.peak_bytes,
           "meta_argument_gb": costs.argument_bytes / 1e9, "card_before_step_gb": before / 1e9,
           "counted_tflop": costs.flops / 1e12, "model_tflop": mf / 1e12,
           "counted_over_model_flops": costs.flops / mf, "step_s": step_s, "loss": loss,
           "launches": {k: c for k, c in got.items() if c}}
    log("launch", f"fitting cell: {json.dumps(fit)}")
    out["fit"] = fit
    out["launches"] = got
    return out


# a child's build and load of the main path's library, reporting whether
# nvcc ran
BUILD_PROBE = ("import json; from repro_torch.kernels import _build; "
               "cold = not _build._library_path('sparse_saga').exists(); "
               "_build.load_library('sparse_saga'); "
               "print(json.dumps({'dir': str(_build.build_dir()), "
               "'built': ['sparse_saga'] if cold else []}))")


def build_cache_check() -> list[dict]:
    """Two child processes against one private build cache
    (``REPRO_COMPILE_CACHE_DIR``), each loading the sparse kernels'
    library: the first builds it, the second builds nothing and loads it."""
    runs = []
    with tempfile.TemporaryDirectory() as cache:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_COMPILE_CACHE_DIR=cache)
        env.pop("REPRO_NO_COMPILE_CACHE", None)
        for _ in range(2):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-c", BUILD_PROBE], cwd=ROOT, env=env,
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"build cache child failed:\n{r.stderr[-4000:]}")
            runs.append({**json.loads(r.stdout.strip().splitlines()[-1]),
                         "s": time.perf_counter() - t0,
                         "libraries": sorted(p.name for p in Path(cache).glob("*.so"))})
    if (runs[0]["built"] != ["sparse_saga"] or runs[1]["built"]
            or {r["dir"] for r in runs} != {cache} or len(runs[1]["libraries"]) != 1):
        raise AssertionError(f"build cache: {runs}")
    log("launch", f"build cache: {json.dumps(runs)}")
    return runs


def launch_run(device) -> dict:
    """``chip_smoke.py --launch`` (a fresh process; it runs alone too): the
    examples, the public entry points, the dry run and the build cache."""
    t_all = time.perf_counter()
    log("launch", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    built = _build.build_all()  # none when the main run built them; all when run alone
    log("launch", f"{sorted(built)} built in {time.perf_counter() - t_all:.1f} s")
    out = {}
    for name, fn in (("examples", lambda: launch_examples(device)),
                     ("entries", lambda: launch_entries(device)),
                     ("dryrun", lambda: launch_dryrun(device)),
                     ("build_cache", build_cache_check)):
        t0 = time.perf_counter()
        out[name] = fn()
        log("launch", f"{name} done in {time.perf_counter() - t0:.1f} s")
    total = dict(out["examples"]["launches"])
    for k, c in out["dryrun"]["launches"].items():
        total[k] = total.get(k, 0) + c
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_all
    log("launch", f"launches {total}; all done in {out['seconds']:.1f} s")
    return out


def ptxas_report(outputs) -> dict:
    """{kernel<dtype,template ints>: registers, spills, static smem} from
    the nvcc -Xptxas -v output of each library (``_build.build_all``)."""
    rep, name = {}, None
    for text in outputs.values():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                mangled = m.group(1)
                base = re.search(r"([a-z_]+_kernel)I", mangled)
                dt = ("bf16" if "nv_bfloat16" in mangled else "f32" if "_kernelIf" in mangled
                      else "f64" if "_kernelId" in mangled else "")
                ints = ",".join(re.findall(r"Li(\d+)E", mangled))
                name = f"{base.group(1) if base else mangled}<{','.join(filter(None, (dt, ints)))}>"
                rep[name] = {}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                rep[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                smem = re.search(r"(\d+) bytes smem", line)
                rep[name].update(registers=int(m.group(1)),
                                 static_smem=int(smem.group(1)) if smem else 0)
    return rep


def flash_smem_bytes(d: int) -> dict[str, int]:
    """Dynamic shared memory a block of each flash kernel asks for at head
    dim `d`, bf16 and float32 (the wrapper's ``tile_plan``, which every bf16
    launch checks against the compiled tiles)."""
    return {f"{name}<{dt}>": plan["smem"]
            for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))
            for name, plan in tile_plan(dtype, d).items()}


def time_flash_d256(device) -> dict:
    """The flash forward and backward at the gossip step's attention shape
    (bf16, B=1, 8/4 heads, S=2048, D=256, causal, window 4096, softcap 50):
    kernel, plain version and bound. No single PyTorch call computes a
    softcapped attention (SDPA has no softcap): no library time. SDPA
    without the softcap on the same tensors is logged beside it as a
    yardstick of the card's rate only: not the same function."""
    b, hq, hkv, s, _, d, causal, window, cap = GEMMA2_ATTENTION[0]
    q, k, v = flash_inputs(b, hq, hkv, s, s, d, torch.bfloat16, device)
    do = flash_inputs(b, hq, hq, s, s, d, torch.bfloat16, device, seed=1)[0]
    o, lse = flash_attention(q, k, v, causal, window, cap, return_lse=True)
    kw = dict(causal=causal, window=window, softcap=cap)
    # causal; the window (4096 > S) keeps every pair
    b_f = kernel_bound("flash_attention", q, k, v, **kw, dtype=torch.bfloat16)
    b_b = kernel_bound("flash_attention_bwd", q, k, v, o, lse, do, **kw, dtype=torch.bfloat16)
    fwd = lambda: flash_attention(q, k, v, causal, window, cap)  # noqa: E731
    bwd = lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw)  # noqa: E731
    out = {
        "flash_attention": {
            "ms": cuda_ms(fwd, iters=50, warmup=5),
            "device_ms": kernel_device_ms(fwd, FLASH_FWD_KERNELS, iters=10),
            "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, **kw), iters=5, warmup=1),
            "bound_ms": b_f[0], "bound_by": b_f[1], "library_ms": None},
        "flash_attention_bwd": {
            "ms": cuda_ms(bwd, iters=20, warmup=3),
            "device_ms": kernel_device_ms(bwd, flash_bwd_kernels(d), iters=5),
            "plain_ms": cuda_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, **kw),
                                iters=3, warmup=1),
            "bound_ms": b_b[0], "bound_by": b_b[1], "library_ms": None},
    }
    split = {n: kernel_device_ms(bwd, (n,), iters=5) for n in flash_bwd_kernels(d)}
    log("attention-profile", f"D=256 (gemma2-2b gossip shape): {json.dumps(out)}; backward "
        f"device ms by kernel {json.dumps(split)}")
    # SDPA has no softcap: the same tensors without it (not the same function)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sd_out = sdpa(*leaves, is_causal=True, enable_gqa=True)
    log("attention-profile", "D=256 SDPA without softcap, not the same function: forward "
        f"{cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), iters=50, warmup=5)}"
        " ms, backward "
        f"{cuda_ms(lambda: torch.autograd.grad(sd_out, leaves, do, retain_graph=True), iters=20, warmup=3)}"
        " ms")
    return out


def topk_profile(device) -> dict:
    """``chip_smoke.py --topk-profile`` (a fresh process): block_topk's
    parity at every case and kind, its times (TOPK_MAIN, TOPK_LONG) and the
    sparse kernels' times at the solver's shape, the
    kernels phase's block_topk and sparse work alone."""
    rcv1 = DATASET_PRESETS["rcv1"]
    log("topk-profile", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    built = _build.build_all()
    log("topk-profile", "ptxas: " + json.dumps(
        {k: v for k, v in ptxas_report(built).items() if k.startswith("block_topk")}))
    return {"parity": topk_parity(device), "block_topk": time_topk(device),
            "sparse": time_kernels(device, 10, rcv1["d"], rcv1["k"])}


def attention_profile(device) -> dict:
    """Run in a fresh process (``chip_smoke.py --attention-profile``; late in
    the main process torch.profiler has dropped kernel events): the bf16
    flash forward and backward at D=128 (the score and train shapes) and at
    D=256 (the gossip shape), by CUDA events and profiler device time, beside
    the plain version, the bound and SDPA (D=128)."""
    return {"flash_attention": time_attention(device),
            "flash_attention_bwd": time_flash_bwd(device), "d256": time_flash_d256(device)}


# ---------------------------------------------------------------------------
# phase 27: comm="sharded", one rank a graph node on the card (--sharded)
# ---------------------------------------------------------------------------

SHARDED_STEPS = 50
SHARDED_LINK_STEPS = 20
SHARDED_TOL = 1e-12  # sharded vs dense on one device: the reference's bar


def gloo_cuda_probe(me, peer):
    """On a rank: exchange a CUDA tensor with ``peer`` through gloo directly,
    without the host staging ``ShardedComm`` does; what it received."""
    import torch.distributed as dist

    x = torch.full((4,), float(me.rank), dtype=torch.float64, device=me.device)
    got = torch.empty_like(x)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                     dist.P2POp(dist.irecv, got, peer)]):
        w.wait()
    return float(got[0])


def gloo_cuda_answer(device) -> str:
    """What gloo does with a CUDA tensor, on a mesh of 2 ranks of its own
    (a rank gloo aborts takes its mesh down with it)."""
    from repro_torch.launch.mesh import NodeMesh

    mesh = NodeMesh(2, device)
    try:
        got = mesh.run(gloo_cuda_probe, [1, 0])
    except RuntimeError as e:  # the probe's finding, logged; the mesh is closed
        lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
        return f"{lines[0]} {lines[-1][:300]}"  # which rank, and its exception
    finally:
        mesh.close()
    return f"delivered {got} (expected [1.0, 0.0])"


def _rank_summary(res, steps) -> dict:
    """A sharded run's per-rank costs: loop ms a step, exchange share, peak
    bytes, summed launches."""
    ranks = res.extras["ranks"]
    loop = [r["loop_s"] for r in ranks]
    share = [r["exchange_s"] / r["loop_s"] for r in ranks]
    staging = [r["staging_s"] / r["loop_s"] for r in ranks]
    launched: dict[str, int] = {}
    for r in ranks:
        for k_, c in r["launches"].items():
            launched[k_] = launched.get(k_, 0) + c
    return {
        "wall_ms_per_step": 1e3 * res.wall_time / steps,
        "rank_loop_ms_per_step": [1e3 * s / steps for s in loop],
        "exchange_share": share,
        "staging_share": staging,
        "peak_bytes": [r["peak_bytes"] for r in ranks],
        "sent_bytes_per_step": [r["sent_bytes"] / steps for r in ranks],
        "launches": launched,
    }


def sharded_checks(device, d, k, n_nodes=10, q=100, steps=SHARDED_STEPS,
                   link_steps=SHARDED_LINK_STEPS, record_every=25, total=None) -> dict:
    """The sharded backend at the rcv1 Section-7 setup on the card (N ranks
    on one device, gloo between them): DSBA and DSA held to the port's dense
    run on the same device (SHARDED_TOL) and on the CPU (DENSE_TOL_CPU),
    one link-fault DSBA run held to the dense fault run; each rank launches
    ``expected_launches`` (summed into ``total``); per-rank times, the
    exchange's share, peak bytes and the collectives record."""
    from repro_torch.core.comm import edge_coloring
    from repro_torch.launch.mesh import make_node_mesh

    total = {} if total is None else total
    cpu = torch.device("cpu")
    problem = paper_problem("ridge", d, k, n_nodes, q)
    colors = edge_coloring(problem.graph.edges, n_nodes)
    out = {"colors": [list(map(list, c)) for c in colors]}
    t0 = time.perf_counter()
    mesh = make_node_mesh(n_nodes, device)
    out["mesh_s"] = time.perf_counter() - t0
    log("sharded", f"{n_nodes} ranks on {device.type} up in {out['mesh_s']:.1f} s; "
        f"{len(colors)} colours {json.dumps(out['colors'])}")
    kw = dict(steps=steps, record_every=record_every)
    want = {k_: n_nodes * c for k_, c in expected_launches(steps, "dense").items()}
    for method in ("dsba", "dsa"):
        row = {}
        dense = [solve(problem, method, device=device, **kw) for _ in range(2)]  # cold, warm
        runs = []
        for _ in range(2):  # cold (the ranks bind the runner), warm
            reset_launches()
            runs.append(solve(problem, method, "sharded", comm_options={"mesh": mesh}, **kw))
            if launches() != dict.fromkeys(WRAPPERS, 0):
                raise AssertionError(f"sharded {method}: the parent launched {launches()}")
            summ = _rank_summary(runs[-1], steps)
            got = summ["launches"]
            if device.type == "cuda" and got != want:
                raise AssertionError(f"sharded {method}: rank launches {got} != {want}")
            for k_, c in got.items():
                total[k_] = total.get(k_, 0) + c
        res = runs[-1]
        ref_cpu = solve(problem, method, device=cpu, **kw)
        row["vs_dense"] = float(np.max(np.abs(res.z - dense[-1].z)))
        row["vs_cpu"] = float(np.max(np.abs(res.z - ref_cpu.z)))
        row["consensus_vs_dense"] = float(np.max(np.abs(res.consensus - dense[-1].consensus)))
        if row["vs_dense"] > SHARDED_TOL or row["consensus_vs_dense"] > SHARDED_TOL:
            raise AssertionError(f"sharded {method} vs dense: {row}")
        if row["vs_cpu"] > DENSE_TOL_CPU:
            raise AssertionError(f"sharded {method} vs CPU: {row}")
        if not np.array_equal(res.doubles_received, dense[-1].doubles_received):
            raise AssertionError(f"sharded {method}: DOUBLEs differ from dense")
        if not (np.all(np.isfinite(res.z)) and res.z.shape == (n_nodes, problem.dim)):
            raise AssertionError(f"sharded {method}: z {res.z.shape}, finite "
                                 f"{np.all(np.isfinite(res.z))}")
        row.update(collectives=res.extras["collectives"],
                   measured_bytes=res.measured_collective_bytes.tolist(),
                   cold_wall_s=runs[0].wall_time, warm=_rank_summary(res, steps),
                   dense_wall_ms_per_step=1e3 * dense[-1].wall_time / steps)
        out[method] = row
        log("sharded", f"{method}: {json.dumps(row)}")

    plan = FaultPlan(link=LinkFault(p=0.2, seed=7))
    lkw = dict(steps=link_steps, record_every=10, comm_options={"fault_plan": plan})
    rd = solve(problem, "dsba", device=device, **lkw)
    rs = solve(problem, "dsba", "sharded", **dict(lkw, comm_options={"fault_plan": plan,
                                                                       "mesh": mesh}))
    got = _rank_summary(rs, link_steps)["launches"]
    lwant = {k_: n_nodes * c for k_, c in expected_launches(link_steps, "dense").items()}
    if device.type == "cuda" and got != lwant:
        raise AssertionError(f"sharded link faults: rank launches {got} != {lwant}")
    for k_, c in got.items():
        total[k_] = total.get(k_, 0) + c
    link = {"vs_dense": float(np.max(np.abs(rs.z - rd.z))), "faults": rs.extras["faults"]}
    if link["vs_dense"] > SHARDED_TOL or rs.extras["faults"] != rd.extras["faults"]:
        raise AssertionError(f"sharded link faults vs dense: {link}, {rd.extras['faults']}")
    if rs.extras["collectives"] != out["dsba"]["collectives"]:
        raise AssertionError("sharded link faults: the counted exchanges differ")
    if not 0 < rs.extras["faults"]["delivered_messages"] < rs.extras["faults"][
            "injected_messages"]:
        raise AssertionError(f"sharded link faults: nothing dropped {rs.extras['faults']}")
    out["link"] = link
    log("sharded", f"link faults p=0.2, {link_steps} steps: {json.dumps(link)}")

    if device.type == "cuda":
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        free, card = torch.cuda.mem_get_info()
        out["card_used_gb"] = (card - free) / 1e9
        out["compute_apps"] = len(apps.splitlines())
        log("sharded", f"{out['compute_apps']} processes on the card, "
            f"{out['card_used_gb']:.2f} GB of it in use (the ranks' contexts and "
            f"tensors, the parent's)")
    pids = mesh.pids()
    mesh.close()
    alive = [p for p in pids if _pid_alive(p)]
    if alive:
        raise AssertionError(f"sharded: workers {alive} outlived close()")
    if device.type == "cuda":
        out["gloo_cuda"] = gloo_cuda_answer(device)
        log("sharded", f"gloo send/recv of a CUDA tensor: {out['gloo_cuda']}")
    out["launches"] = total
    return out


def _pid_alive(pid: int) -> bool:
    """Whether process ``pid`` exists (``close`` joins, so reaps, its
    workers)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def sharded_run(device) -> dict:
    """``chip_smoke.py --sharded`` (a fresh process): ``sharded_checks`` with
    N = 10 ranks on the card at the rcv1 Section-7 setup. Its launches
    (summed over the ranks) join the kernels line."""
    t_all = time.perf_counter()
    log("sharded", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    rcv1 = DATASET_PRESETS["rcv1"]
    out = sharded_checks(device, rcv1["d"], rcv1["k"])
    out["seconds"] = time.perf_counter() - t_all
    log("sharded", f"launches {out['launches']}; all done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 28: the gossip step over ranks, one process a pod (--gossip-ranks)
# ---------------------------------------------------------------------------

GOSSIP_DENSE_STEPS = 1
# a rank's loss and grad norm against the local run's: the same per-pod bits,
# combined in another order (the mean of the pods' losses on the host; the
# grad norm from each pod's sum of squares, where the local run takes each
# leaf's norm over both pods at once): float32 summation order, ~1e-7 a sum
GOSSIP_METRIC_RTOL = 1e-5


def _card_memory() -> dict:
    """The card's memory in use and its processes (``nvidia-smi``)."""
    used = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used,memory.total", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    return {"memory_used_total": used, "compute_apps": apps}


def gossip_rank_steps(mesh, setup, steps, s, checked=True) -> tuple:
    """`steps` gossip steps of `setup` over the ranks of `mesh` from seed 0,
    each checked: no launch in the parent, each rank's launches as
    predicted on the card, finite metrics, the bytes each rank sent equal
    to 2 x the closed form a shift (with compression; else 2 x the model a
    shift). A `checked` run also holds step 0's kernel calls on the ranks
    to their plain versions, checks every stream received against the one
    sent, takes the consensus distance (an ``all_reduce`` of the model a
    rank) after its last step and gathers the final params to the host
    through the mesh's pipes (``gather_gossip_state``: a full-width model a
    rank, in pieces). Returns (rows, launches summed over the ranks, the
    final params: the gathered pod-stacked host tree of a `checked` run,
    else their ``pod_digests``)."""
    cfg, tc, gcfg = setup
    dev = mesh.device
    ld = LoaderConfig(cfg.vocab_size, gcfg.n_pods, s, n_shards=gcfg.n_pods)
    shapes = [d.shape for d in tree_leaves(T.model_defs(cfg))]
    n_shifts = len(gcfg.shifts_and_weights()[0])
    per_rank = 2 * n_shifts * (wire_bytes_per_pod(shapes, gcfg) if gcfg.compression != "none"
                               else 4 * tree_num_params(T.model_defs(cfg)))
    want = (expected_gossip_launches(cfg, dataclasses.replace(gcfg, n_pods=1))
            if dev.type == "cuda" else dict.fromkeys(WRAPPERS, 0))
    if gcfg.compression == "none":
        want["block_topk"] = 0
    want = {k: want[k] for k in ("block_topk", "flash_attention", "flash_attention_bwd")}
    t0 = time.perf_counter()
    handle = init_gossip_state(cfg, tc, gcfg, 0, dev, mesh=mesh)
    step_fn = make_gossip_train_step(mesh, cfg, tc, gcfg)
    log("gossip-ranks", f"compression {gcfg.compression}: the ranks drew their states in "
        f"{time.perf_counter() - t0:.1f} s")
    total: dict[str, int] = {}
    rows = []
    for i in range(steps):
        check = checked and i == 0
        reset_launches()
        t0 = time.perf_counter()
        handle, m = step_fn(handle, gossip_batch(ld, gcfg.n_pods, s, i), check=check)
        wall = time.perf_counter() - t0
        if launches() != dict.fromkeys(WRAPPERS, 0):
            raise AssertionError(f"gossip ranks step {i}: the parent launched {launches()}")
        for r, rk in enumerate(m["ranks"]):
            if rk["launches"] != want:
                raise AssertionError(f"gossip ranks step {i}: rank {r} launched "
                                     f"{rk['launches']} != {want}")
            for k, c in rk["launches"].items():
                total[k] = total.get(k, 0) + c
        row = {"step": i, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "sent_bytes": m["sent_bytes"], "wall_s": wall,
               "rank_wall_s": [rk["wall_s"] for rk in m["ranks"]],
               "exchange_s": [rk["exchange_s"] for rk in m["ranks"]],
               "staging_s": [rk["staging_s"] for rk in m["ranks"]],
               "peak_gb": [None if rk["peak_bytes"] is None else rk["peak_bytes"] / 1e9
                           for rk in m["ranks"]]}
        if checked and i == steps - 1:
            t0 = time.perf_counter()
            row["consensus_distance"] = float(consensus_distance(handle))
            row["consensus_s"] = time.perf_counter() - t0
        if check:
            row["streams_checked"] = m["streams_checked"]
            row["held"] = [{k: {"calls": len(h["max_abs"]),
                                "max_abs": max(h["max_abs"], default=0.0),
                                "rel": max(h["rel"], default=0.0), "exact": all(h["exact"])}
                            for k, h in (rk["held"] or {}).items()} for rk in m["ranks"]]
            if dev.type == "cuda":
                for r, hd in enumerate(row["held"]):
                    calls = {k: hd[k]["calls"] for k in hd}
                    if calls != {"block_topk": want["block_topk"],
                                 "flash_attention": want["flash_attention"],
                                 "flash_attention_bwd": want["flash_attention_bwd"] // 2}:
                        raise AssertionError(f"gossip ranks: rank {r} held {calls}")
                    if not hd["block_topk"]["exact"]:
                        raise AssertionError(f"gossip ranks: rank {r}'s block_topk calls are "
                                             "not bit-equal to the plain version")
        log("gossip-ranks", json.dumps(row))
        if not all(math.isfinite(v) for k, v in row.items()
                   if k in ("loss", "grad_norm", "consensus_distance")):
            raise AssertionError(f"gossip ranks step {i}: not finite {row}")
        if m["sent_bytes"] != [per_rank] * gcfg.n_pods:
            raise AssertionError(f"gossip ranks step {i}: sent {m['sent_bytes']} bytes a rank "
                                 f"!= {per_rank}")
        rows.append(row)
    if dev.type == "cuda":
        card = _card_memory()
        log("gossip-ranks", f"the card while the ranks hold the state: {json.dumps(card)}")
        rows[-1]["card"] = card
    t0 = time.perf_counter()
    if checked:
        final = gather_gossip_state(handle, "cpu", keys=("params",))["params"]
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(final))
        rows[-1]["gather"] = {"bytes": nbytes, "s": time.perf_counter() - t0}
        log("gossip-ranks", f"params gathered through the pipes: {nbytes / 1e9:.2f} GB in "
            f"{rows[-1]['gather']['s']:.1f} s")
    else:
        final = pod_digests(handle)
        log("gossip-ranks", f"params hashed on the ranks in {time.perf_counter() - t0:.1f} s")
    handle.close()
    return rows, total, final


def gossip_ranks_checks(device, setup, steps=GOSSIP_STEPS, dense_steps=GOSSIP_DENSE_STEPS,
                        s=GOSSIP_S) -> dict:
    """The gossip step of `setup` over ``n_pods`` ranks sharing `device`
    (``make_node_mesh``): `steps` steps with the setup's compression, then
    `dense_steps` with compression "none", each from seed 0 (rows, launches
    summed over the ranks, and the final params' ``pod_digests``). Closes
    the mesh and checks that no worker outlived it."""
    from repro_torch.launch.mesh import make_node_mesh

    cfg, tc, gcfg = setup
    t0 = time.perf_counter()
    mesh = make_node_mesh(gcfg.n_pods, device)
    out = {"mesh_s": time.perf_counter() - t0}
    log("gossip-ranks", f"{gcfg.n_pods} ranks on {device.type} up in {out['mesh_s']:.1f} s")
    t0 = time.perf_counter()
    out["rows"], total, out["params"] = gossip_rank_steps(mesh, setup, steps, s)
    out["compressed_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = (cfg, tc, dataclasses.replace(gcfg, compression="none"))
    out["dense_rows"], dense_total, out["dense_params"] = gossip_rank_steps(
        mesh, dense, dense_steps, s, checked=False)
    out["dense_s"] = time.perf_counter() - t0
    for k, c in dense_total.items():
        total[k] = total.get(k, 0) + c
    sent = out["rows"][-1]["sent_bytes"][0]
    dense_sent = out["dense_rows"][-1]["sent_bytes"][0]
    out["bytes_a_rank"] = {"compressed": sent, "dense": dense_sent,
                           "dense_over_compressed": dense_sent / sent}
    log("gossip-ranks", f"bytes a rank a step: {json.dumps(out['bytes_a_rank'])}")
    pids = mesh.pids()
    mesh.close()
    alive = [p for p in pids if _pid_alive(p)]
    if alive:
        raise AssertionError(f"gossip ranks: workers {alive} outlived close()")
    out["launches"] = total
    return out


def _hold_params(tag, got, want) -> dict:
    """Each rank's final params against its pod's in the local run, by
    ``pod_digests``: bit-equal, or the leaves that differ with their
    float64 norms' relative difference."""
    out = {"leaves": 0, "bit_equal": True}
    for p, (g, w) in enumerate(zip(got, want, strict=True)):
        for path, (sha, norm) in w.items():
            out["leaves"] += 1
            if g[path][0] != sha:
                out["bit_equal"] = False
                out.setdefault("differ", {})[f"pod {p}: {path}"] = (
                    abs(g[path][1] - norm) / norm if norm else g[path][1])
    log("gossip-ranks", f"{tag}: final params vs the local run: {json.dumps(out)}")
    if not out["bit_equal"]:
        raise AssertionError(f"{tag}: the ranks' params are not the local run's: {out}")
    return out


def _hold_gathered(tag, got, want) -> dict:
    """The params gathered from the ranks against the local run's (both
    pod-stacked host trees), leaf by leaf, bit for bit."""
    differ = []
    tree_map(lambda path, a, b: torch.equal(a, b) or differ.append("/".join(path)), got, want)
    out = {"leaves": len(tree_leaves(want)), "bit_equal": not differ,
           "bytes": sum(t.numel() * t.element_size() for t in tree_leaves(got))}
    log("gossip-ranks", f"{tag}: gathered params vs the local run: {json.dumps(out)}")
    if differ:
        raise AssertionError(f"{tag}: the gathered params are not the local run's: {differ}")
    return out


def hold_ranks_to_local(out, ref, dense_ref) -> dict:
    """The rank runs of ``gossip_ranks_checks`` against the local runs
    (rows with loss and grad norm, params on the host): every step's loss
    and grad norm within GOSSIP_METRIC_RTOL, the final params bit for bit
    (the compressed run's gathered through the pipes, the dense run's by
    equal SHA-256 digests, leaf by leaf and pod by pod)."""
    for tag, rows, (ref_rows, _) in (("compressed", out["rows"], ref),
                                      ("none", out["dense_rows"], dense_ref)):
        for row, want in zip(rows, ref_rows):
            for k in ("loss", "grad_norm"):
                if abs(row[k] - want[k]) > GOSSIP_METRIC_RTOL * abs(want[k]):
                    raise AssertionError(f"gossip ranks, {tag}, step {row['step']}: {k} "
                                         f"{row[k]} against the local run's {want[k]}")
    return {"params": _hold_gathered("compressed", out["params"], ref[1]),
            "dense_params": _hold_params("none", out["dense_params"], dense_ref[1])}


def gossip_ranks_run(device) -> dict:
    """``chip_smoke.py --gossip-ranks`` (a fresh process): the gossip steps
    over 2 ranks sharing the card, then, with the ranks closed, phase 12's
    local gossip run (all its checks) and its uncompressed run as the
    reference, held against them. The ranks run first: their two peaks
    (37.75 GB each) take 75.5 of the card's 85 GB, so nothing else may hold
    memory on the card then. The launches of the ranks and of the local
    run join the kernels line."""
    t_all = time.perf_counter()
    log("gossip-ranks", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    built = _build.build_all()  # nothing when the full run built them first
    log("gossip-ranks", f"{sorted(built)} built in {time.perf_counter() - t_all:.1f} s")
    setup = gossip_setup()
    cfg, tc, gcfg = setup
    out = gossip_ranks_checks(device, setup)
    t0 = time.perf_counter()
    summary, local_launches, params = gossip_phase(device, host_params=True)
    ref = ([{"loss": r["loss"], "grad_norm": r["grad_norm"]} for r in summary["steps"]], params)
    dense = (cfg, tc, dataclasses.replace(gcfg, compression="none"))
    dense_ref = gossip_trajectory(device, dense, GOSSIP_DENSE_STEPS, GOSSIP_DENSE_STEPS)
    out["local_s"] = time.perf_counter() - t0
    log("gossip-ranks", f"local runs done in {out['local_s']:.1f} s; the parent holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; the card: "
        f"{json.dumps(_card_memory())}")
    held = hold_ranks_to_local(out, ref, dense_ref)
    del params, ref
    out.pop("params")
    out["held_to_local"] = held
    out["local"] = summary
    out["local_consensus_without_compression"] = [r["consensus_distance"] for r in dense_ref[0]]
    for k, c in local_launches.items():
        out["launches"][k] = out["launches"].get(k, 0) + c
    out["seconds"] = time.perf_counter() - t_all
    log("gossip-ranks", f"launches {out['launches']}; all done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phases 29 and 30: the within-pod FSDP x TP train step, a (data, model) mesh
# of ranks on the card (--fsdp: the dense family; --fsdp-families: the moe,
# ssm and hybrid families)
# ---------------------------------------------------------------------------

FSDP_B, FSDP_S, FSDP_MESH = 2, 2048, (2, 2)
# PERF.md's "on vs off" bars at bf16 compute: the sharded step against the
# unsharded one is the same function in another summation order
FSDP_LOSS_RTOL = 1e-3
FSDP_GNORM_RTOL = 5e-2
FSDP_CHANGE_REL = 5e-2  # each leaf's change over the steps, relative norm

# arch -> (layers, AdamW steps, planted fault or None), each at full width
# cut in depth: gemma2-2b to one local/global pair, 3 steps (its change bar
# was set on 3; at 2 its sound step read 0.0587, PERF.md §6); mamba2 to 2
# layers; zamba2 to 12 (the shared block used twice); qwen2-moe to 1 (its
# own capacity factor 1.25: 384 slots an expert for 273 pairs on average at
# B=2 x S=2048, so no pair drops; its fault, the capacity of one data rank's
# rows, 256, drops those past it)
FSDP_DENSE = {"gemma2-2b": (2, 3, "rows")}
FSDP_FAMILIES = {"mamba2-1.3b": (2, 2, "rows"), "zamba2-1.2b": (12, 2, None),
                 "qwen2-moe-a2.7b": (1, 2, "capacity")}
# the planted faults (``fsdp_fault``; "dispatch_grad" is read by
# ``tools/fsdp_control_probe.py --moe-faults``)
FSDP_FAULTS = {"rows": "data shard 1's rows = shard 0's",
               "capacity": "the MoE capacity from a rank's own rows",
               "dispatch_grad": "the MoE dispatch's input gradient not summed over model"}
# zamba2 x12 compares in float32 compute: in bf16 its sharded step reads
# 0.065 on the change bar against a 2-microbatch control of 0.031, which
# shares the unsharded forward's bits. Measured cause (``fsdp_grad_check``,
# PERF.md §6): each leaf's bf16 gradient, sharded or not, lies 0.97-1.02
# times as far from the float32 one (wB, wC, conv_B, conv_C and ln too),
# the sharded 0.35-0.74 of that from the unsharded: the split sums round
# the forward otherwise, and AdamW's sign-like first steps turn that into
# change. Its bf16 gradient is held there
FAMILY_CONFIG = {"zamba2-1.2b": {"compute_dtype": torch.float32}}
# the archs whose one-step bf16 gradient is held to the float32 one
FSDP_GRAD_CHECK = ("zamba2-1.2b",)
# a leaf of the sharded bf16 gradient lies at most GRAD_FACTOR x the farther
# of the unsharded bf16 step and its control from the float32 gradient, plus
# GRAD_FLOOR (PERF.md §6)
GRAD_FACTOR, GRAD_FLOOR = 2.0, 1e-3


def fsdp_family_setup(arch, layers, **over):
    """(model config, TrainConfig) of phases 29-30: `arch` at full width cut
    to `layers` layers (compute dtype per FAMILY_CONFIG, fields of `over`
    last), the flash and SSD kernels on, the default AdamW."""
    cfg = dataclasses.replace(get_config(arch), n_layers=layers, attention_kernel="on",
                              ssm_kernel="on", **{**FAMILY_CONFIG.get(arch, {}), **over})
    return cfg, TrainConfig()


# the families whose attention phase 30 conditions (``condition_attention``)
FAMILY_CONDITIONED = ("moe", "hybrid")


def _attention_leaves(cfg, params) -> dict:
    """The attention projections ``condition_attention`` rescales: the
    hybrid's shared block's, else the stacked layers'."""
    return params["shared_attn"]["attn"] if cfg.family == "hybrid" else params["blocks"]["attn"]


def condition_rank_attention(me, token) -> None:
    """A rank job: ``condition_attention`` on this rank's blocks of the
    attention projections of the train state under `token` (each leaf's
    scale is one scalar, so a block of the rescaled leaf is the rescaled
    block)."""
    from repro_torch.train import sharded

    del me
    rec = sharded._RANK_STATES[token]
    condition_attention(rec["cfg"], _attention_leaves(rec["cfg"], rec["state"]["params"]))


def fsdp_init(setup, device=None, mesh=None):
    """``init_train_state`` of `setup` from seed 0, on `device` or on the
    ranks of `mesh`; for the families of FAMILY_CONDITIONED with the
    attention conditioned (``condition_attention``): with the reference's
    init their softmax is near an argmax and a step is a chaotic function
    of bf16 rounding (``tools/fsdp_control_probe.py``: zamba2's unsharded
    step against itself at 2 microbatches moves its leaves 0.43-0.55 apart
    in relative norm), which no comparison of two summation orders can
    hold."""
    cfg, tc = setup
    state = init_train_state(cfg, tc, 0, device, mesh=mesh)
    if cfg.family in FAMILY_CONDITIONED:
        if mesh is None:
            condition_attention(cfg, _attention_leaves(cfg, state["params"]))
        else:
            mesh.run(condition_rank_attention, [state.token] * mesh.n)
    return state


def fsdp_reference(device, setup, batches, out_dir, tag="fsdp") -> dict:
    """The unsharded port ``train_step`` on the same seed and batches: each
    step's loss, grad norm and wall, the peak, and the parameters before
    and after as one ``.npy`` a leaf under `out_dir` (the ranks read their
    blocks of them); the card is freed before it returns."""
    cfg, tc = setup
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = fsdp_init(setup, device)
    files = {"p0": {}, "final": {}}
    reset_launches()

    def save(key):
        def one(path, t):
            f = os.path.join(out_dir, f"{key}_{'_'.join(path)}.npy")
            np.save(f, t.detach().cpu().numpy())
            files[key]["/".join(path)] = f
        tree_map(one, state["params"])

    t0 = time.perf_counter()
    save("p0")
    rows = []
    for i, batch in enumerate(batches):
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = train_step(cfg, tc, state, batch)
        if cuda:
            torch.cuda.synchronize()
        rows.append({"step": i, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "lr": m["lr"], "wall_s": time.perf_counter() - t1})
    save("final")
    got = {k: c for k, c in launches().items() if c}
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out = {"rows": rows, "files": files, "peak_gb": peak, "launches": got,
           "seconds": time.perf_counter() - t0}
    log(tag, f"unsharded reference: {json.dumps(rows)}; peak {peak} GB")
    return out


def leaf_change_rel(name, t, files) -> float:
    """|t - final| / |final - p0| of the leaf `name` (a "/"-joined path)
    against `files` ({"p0", "final"}: path -> ``.npy``), in float64 on t's
    device: the distance of two changes from p0, relative to the second."""
    final = torch.from_numpy(np.load(files["final"][name])).to(t.device, torch.float64)
    p0 = torch.from_numpy(np.load(files["p0"][name])).to(t.device, torch.float64)
    return float(torch.linalg.vector_norm(t.double() - final)
                 / torch.linalg.vector_norm(final - p0))


def fsdp_control(device, setup, batches, ref, tag="fsdp", truth=None) -> dict:
    """The unsharded step again with 2 microbatches: the same function in
    another summation order (float32 accumulation of two half-batch
    gradients), held to the reference by the same measures as the ranks
    (loss and grad norm a step, each leaf's change): the spread the
    rounding alone gives at this depth and dtype. With `truth` (files as
    ``leaf_change_rel`` takes them) each leaf's change against it too."""
    cfg, tc = setup
    tc2 = dataclasses.replace(tc, microbatches=2)
    state = fsdp_init((cfg, tc2), device)
    rows = []
    for i, batch in enumerate(batches):
        state, m = train_step(cfg, tc2, state, batch)
        r = ref["rows"][i]
        rows.append({"step": i, "loss_rel": abs(float(m["loss"]) - r["loss"]) / abs(r["loss"]),
                     "grad_norm_rel": abs(float(m["grad_norm"]) - r["grad_norm"])
                     / r["grad_norm"]})
    change, vs_truth = {}, {}

    def one(path, t):
        name = "/".join(path)
        change[name] = leaf_change_rel(name, t, ref["files"])
        if truth is not None:
            vs_truth[name] = leaf_change_rel(name, t, truth)
    with torch.no_grad():
        tree_map(one, state["params"])
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"rows": rows, "change_rel": change, "worst_change_rel": max(change.values())}
    if truth is not None:
        out["vs_truth"] = vs_truth
    log(tag, f"control, the unsharded step at 2 microbatches: {json.dumps(out)}")
    return out


# a rank's kernels of the within-pod step, and the launches a held call makes
FSDP_KERNELS = {"flash_attention": 1, "flash_attention_bwd": 2, "ssd_chunk": 1,
                "ssd_chunk_bwd": 3}


def expected_fsdp_launches(cfg) -> dict[str, int]:
    """A rank's launches a step: a forward kernel twice a use with remat
    (forward and recompute), once without; the backward's kernels once a
    use (flash 2, SSD 3). The attention layers (dense, moe) or the shared
    block's uses (hybrid) run flash; the ssm layers the SSD pair."""
    fwd = 2 if cfg.remat != "none" else 1
    attn = {"dense": cfg.n_layers, "moe": cfg.n_layers,
            "hybrid": cfg.n_layers // cfg.hybrid_period}.get(cfg.family, 0)
    ssm = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    return {"flash_attention": fwd * attn, "flash_attention_bwd": 2 * attn,
            "ssd_chunk": fwd * ssm, "ssd_chunk_bwd": 3 * ssm}


def _by_leaf(diffs, key="change_rel") -> dict:
    """The largest `key` of each leaf over the ranks' ``shard_diffs``."""
    out = {}
    for d in diffs:
        for k, v in d.items():
            out[k] = max(out.get(k, 0.0), v[key])
    return out


def fsdp_checks(device, setup, ref, batches, mesh, tag="fsdp", fault=None, hold_change=True,
                truth=None) -> dict:
    """The sharded step of `setup` on `mesh` (a ("data", "model") mesh of
    ranks sharing `device`), from seed 0, held to the unsharded reference
    `ref` (``fsdp_reference``): each rank's initial blocks bit-equal to the
    reference's p_0; every step 0 launches in the parent and the predicted
    launches a rank (step 0's calls held to their plain versions), every
    rank's sent bytes equal to the closed form from the pspecs
    (``expected_sent_bytes``), loss within FSDP_LOSS_RTOL and grad norm
    within FSDP_GNORM_RTOL; after the steps each parameter leaf's change
    within FSDP_CHANGE_REL (relative norm; without `hold_change` logged
    only) of the unsharded change and every element within 2 x steps x the
    largest lr;
    with `truth` (files as ``leaf_change_rel`` takes them) each leaf's
    change against it too (``vs_truth``); then, with `fault`, that planted
    fault (``fsdp_fault``) past the change bar. The caller closes the
    mesh."""
    from repro_torch.train.sharded import expected_sent_bytes, shard_diffs

    cfg, tc = setup
    cuda = device.type == "cuda"
    out = {"mesh": mesh.mesh_shape}
    t0 = time.perf_counter()
    handle = fsdp_init(setup, mesh=mesh)
    init = shard_diffs(handle, ref["files"]["p0"])
    bad = {f"rank {r}: {k}": v["max_abs"] for r, d in enumerate(init) for k, v in d.items()
           if v["max_abs"] != 0.0}
    if bad:
        raise AssertionError(f"{tag}: initial blocks differ from the unsharded init: {bad}")
    out["init_s"] = time.perf_counter() - t0
    log(tag, f"the ranks drew their blocks in {out['init_s']:.1f} s, bit-equal to the "
        "unsharded init")
    step_fn = train_mod.make_jitted_train_step(mesh, cfg, tc)
    n_rows, seq = batches[0]["tokens"].shape
    closed = expected_sent_bytes(cfg, tc, mesh.mesh_shape, n_rows, seq)
    want = expected_fsdp_launches(cfg) if cuda else dict.fromkeys(FSDP_KERNELS, 0)
    rows, total = [], dict.fromkeys(want, 0)
    for i, batch in enumerate(batches):
        reset_launches()
        t0 = time.perf_counter()
        handle, m = step_fn(handle, batch, check=i == 0)
        wall = time.perf_counter() - t0
        if launches() != dict.fromkeys(WRAPPERS, 0):
            raise AssertionError(f"{tag} step {i}: the parent launched {launches()}")
        r_ref = ref["rows"][i]
        row = {"step": i, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "ref_loss": r_ref["loss"], "ref_grad_norm": r_ref["grad_norm"],
               "wall_s": wall, "ref_wall_s": r_ref["wall_s"], "closed_form_bytes": closed,
               "ranks": []}
        for r, rk in enumerate(m["ranks"]):
            if rk["launches"] != want:
                raise AssertionError(f"{tag} step {i}: rank {r} launched {rk['launches']} != "
                                     f"{want}")
            for k, c in rk["launches"].items():
                total[k] += c
            coll = {ax: {k: round(v["seconds"], 4) for k, v in kinds.items()}
                    for ax, kinds in rk["collectives"].items()}
            row["ranks"].append({
                "coords": rk["coords"], "wall_s": rk["wall_s"],
                "collective_s": rk["collective_s"],
                "collective_share": rk["collective_s"] / rk["wall_s"],
                "gather_s": sum(v["gather"] for v in coll.values()),
                "reduce_scatter_s": sum(v["reduce_scatter"] for v in coll.values()),
                "tp_all_reduce_s": coll["model"]["all_reduce"],
                "data_all_reduce_s": coll["data"]["all_reduce"],
                "sent_bytes": rk["sent_bytes"],
                "peak_gb": None if rk["peak_bytes"] is None else rk["peak_bytes"] / 1e9})
            if i == 0 and cuda:
                held = rk["held"]
                calls = {k: len(h["max_abs"]) for k, h in held.items()}
                if calls != {k: want[k] // per for k, per in FSDP_KERNELS.items()}:
                    raise AssertionError(f"{tag}: rank {r} held {calls}")
                row["ranks"][-1]["held"] = {k: {"calls": len(h["max_abs"]),
                                                "max_abs": max(h["max_abs"], default=0.0),
                                                "rel": max(h["rel"], default=0.0)}
                                            for k, h in held.items() if h["max_abs"]}
        log(tag, json.dumps(row))
        if not (math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])):
            raise AssertionError(f"{tag} step {i}: not finite {row}")
        if m["sent_bytes"] != [closed] * mesh.n:
            raise AssertionError(f"{tag} step {i}: sent {m['sent_bytes']} bytes a rank != the "
                                 f"closed form {closed}")
        if abs(row["loss"] - r_ref["loss"]) > FSDP_LOSS_RTOL * abs(r_ref["loss"]):
            raise AssertionError(f"{tag} step {i}: loss {row['loss']} against {r_ref['loss']}")
        if abs(row["grad_norm"] - r_ref["grad_norm"]) > FSDP_GNORM_RTOL * r_ref["grad_norm"]:
            raise AssertionError(f"{tag} step {i}: grad norm {row['grad_norm']} against "
                                 f"{r_ref['grad_norm']}")
        rows.append(row)
    if cuda:
        out["card"] = _card_memory()
        log(tag, f"the card while the ranks hold the state: {json.dumps(out['card'])}")
    t0 = time.perf_counter()
    diffs = shard_diffs(handle, ref["files"]["final"], ref["files"]["p0"])
    elem_bar = 2 * len(batches) * max(r["lr"] for r in ref["rows"])
    worst = {key: max(v[key] for d in diffs for v in d.values())
             for key in ("change_rel", "max_abs")}
    out["params_vs_unsharded"] = dict(worst, leaves=sum(len(d) for d in diffs),
                                      elem_bar=elem_bar, change_rel_by_leaf=_by_leaf(diffs),
                                      seconds=time.perf_counter() - t0)
    log(tag, f"final blocks vs the unsharded params: {json.dumps(out['params_vs_unsharded'])}")
    if truth is not None:
        out["vs_truth"] = _by_leaf(shard_diffs(handle, truth["final"], truth["p0"]))
    for r, d in enumerate(diffs):
        for k, v in d.items():
            if (hold_change and v["change_rel"] > FSDP_CHANGE_REL) or v["max_abs"] > elem_bar:
                raise AssertionError(f"{tag}: rank {r}, {k}: change {v['change_rel']} "
                                     f"(bar {FSDP_CHANGE_REL}), max abs {v['max_abs']} "
                                     f"(bar {elem_bar})")
    handle.close()
    if fault:
        out["fault"] = fsdp_fault(mesh, setup, ref, batches, step_fn, fault, tag)
    out.update(rows=rows, launches=total)
    return out


def close_mesh(mesh, tag) -> None:
    """Close `mesh` and check that none of its workers outlived it."""
    pids = mesh.pids()
    mesh.close()
    alive = [p for p in pids if _pid_alive(p)]
    if alive:
        raise AssertionError(f"{tag}: workers {alive} outlived close()")


class _NoDispatchSum:
    """A grid whose "model" axis leaves x's gradient through the MoE
    dispatch as each rank's share (``copy_to`` the identity both ways)."""

    def __init__(self, grid):
        self._grid = grid
        self.model = _NoSum(grid.model)

    def __getattr__(self, name):
        return getattr(self._grid, name)


class _NoSum:
    """An axis' collectives with ``copy_to``'s backward sum left out."""

    def __init__(self, comm):
        self._comm = comm

    def __getattr__(self, name):
        return getattr(self._comm, name)

    def copy_to(self, x):
        return x


_SOUND = {}


def plant_fault(me, fault) -> None:
    """A rank job: plant `fault` of FSDP_FAULTS in this rank's port; with
    None, the sound functions back. "capacity": the MoE capacity from the
    rank's own rows, not the data line's (positions stay global, so the
    pairs past it drop); "dispatch_grad": x's gradient through the MoE
    dispatch left as each model rank's share, not summed over "model"."""
    from repro_torch.models import layers

    del me
    if fault is None:
        for name, f in _SOUND.items():
            setattr(layers, name, f)
        _SOUND.clear()
        return
    if fault == "capacity":
        sound = _SOUND["scatter_slots"] = layers.scatter_slots

        def scatter_slots(cfg, p, x, grid=None):
            xt, w, e, pos, keep, C = sound(cfg, p, x, grid)
            if grid is not None:
                C = max(1, int(x.shape[0] * x.shape[1] * cfg.experts_per_token / cfg.n_experts
                               * cfg.capacity_factor))
                C = -(-C // 128) * 128 if C > 128 else C
            return xt, w, e, pos, pos < C, C

        layers.scatter_slots = scatter_slots
    else:
        sound = _SOUND["_grid_moe_scatter"] = layers._grid_moe_scatter
        layers._grid_moe_scatter = lambda cfg, grid, p, x: sound(cfg, _NoDispatchSum(grid), p, x)


def fsdp_fault(mesh, setup, ref, batches, step_fn, fault, tag="fsdp") -> dict:
    """A planted fault (FSDP_FAULTS) read by the sound run's measures, the
    sharded step from seed 0: "rows", data shard 1's rows replaced by shard
    0's, as if one data rank's rows were left out of the gradient and the
    other's counted twice; any other, ``plant_fault`` in every rank.
    The change bar must tell it from a sound step (its worst leaf past
    FSDP_CHANGE_REL); the loss, grad-norm and element readings are
    recorded beside the sound run's. Every element's bar, 2 x steps x lr,
    is AdamW's own bound on two trajectories of that many steps (each
    element moves about lr a step), so it catches non-finite or mis-scaled
    updates only."""
    from repro_torch.train.sharded import shard_diffs

    t0 = time.perf_counter()
    per = batches[0]["tokens"].shape[0] // mesh.mesh_shape["data"]

    def planted(b):
        if fault != "rows":
            return b
        return {k: np.concatenate([v[:per], v[:per], v[2 * per:]]) for k, v in b.items()}

    handle = fsdp_init(setup, mesh=mesh)
    if fault != "rows":
        mesh.run(plant_fault, [fault] * mesh.n)
    rows = []
    try:
        for i, batch in enumerate(batches):
            handle, m = step_fn(handle, planted(batch))
            r = ref["rows"][i]
            rows.append({"step": i,
                         "loss_rel": abs(float(m["loss"]) - r["loss"]) / abs(r["loss"]),
                         "grad_norm_rel": abs(float(m["grad_norm"]) - r["grad_norm"])
                         / r["grad_norm"]})
    finally:
        if fault != "rows":
            mesh.run(plant_fault, [None] * mesh.n)
    diffs = shard_diffs(handle, ref["files"]["final"], ref["files"]["p0"])
    handle.close()
    by_leaf = _by_leaf(diffs)
    out = {"fault": fault, "rows": rows, "worst_change_rel": max(by_leaf.values()),
           "least_change_rel": min(by_leaf.values()),
           "max_abs": max(v["max_abs"] for d in diffs for v in d.values()),
           "change_rel_by_leaf": by_leaf, "seconds": time.perf_counter() - t0}
    log(tag, f"planted fault ({FSDP_FAULTS[fault]}): {json.dumps(out)}")
    if out["worst_change_rel"] <= FSDP_CHANGE_REL:
        raise AssertionError(f"{tag}: the change bar {FSDP_CHANGE_REL} does not catch the "
                             f"planted fault {fault!r} ({out['worst_change_rel']})")
    return out


def fsdp_grad_check(device, arch, layers, batch, mesh) -> dict:
    """One step of SGD momentum at lr 1 (no warmup, decay or clipping) moves
    each leaf by its gradient. For `arch` x `layers` in bf16 compute, from
    the phase's init: each leaf's gradient against the float32-compute
    gradient of the unsharded step (the truth), for the unsharded bf16
    step, its 2-microbatch control and the sharded step on `mesh`
    (``fsdp_checks``: step 0 held, bytes, loss and grad norm against the
    unsharded bf16 step, the change logged only). Fails if a leaf of the
    sharded gradient lies farther from the truth than GRAD_FACTOR x the
    farther of the unsharded step and its control, plus GRAD_FLOOR: a
    model-axis sum left out of a leaf that every model rank reads in part
    puts it a fraction of its norm away."""
    tag = f"fsdp-{arch} grad"
    t0 = time.perf_counter()
    sgd = TrainConfig(optimizer=AdamConfig(kind="sgdm", lr=1.0, warmup_steps=0,
                                           weight_decay=0.0, grad_clip=1e9))
    cfg = fsdp_family_setup(arch, layers, compute_dtype=torch.bfloat16)[0]
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    with tempfile.TemporaryDirectory() as d:
        os.mkdir(os.path.join(d, "truth"))
        os.mkdir(os.path.join(d, "bf16"))
        truth = fsdp_reference(device, (f32, sgd), [batch], os.path.join(d, "truth"), tag)
        ref = fsdp_reference(device, (cfg, sgd), [batch], os.path.join(d, "bf16"), tag)
        unsharded = {}
        for name, f in ref["files"]["final"].items():
            unsharded[name] = leaf_change_rel(name, torch.from_numpy(np.load(f)).to(device),
                                              truth["files"])
        control = fsdp_control(device, (cfg, sgd), [batch], ref, tag, truth["files"])
        res = fsdp_checks(device, (cfg, sgd), ref, [batch], mesh, tag, hold_change=False,
                          truth=truth["files"])
    sharded = res["vs_truth"]
    bar = {k: GRAD_FACTOR * max(unsharded[k], control["vs_truth"][k]) + GRAD_FLOOR
           for k in sharded}
    out = {"vs_truth": {"unsharded": unsharded, "control": control["vs_truth"],
                        "sharded": sharded},
           "sharded_vs_unsharded": res["params_vs_unsharded"]["change_rel_by_leaf"],
           "control_vs_unsharded": control["change_rel"],
           "worst_share_of_bar": max(sharded[k] / bar[k] for k in sharded),
           "launches": {k: res["launches"][k] + ref["launches"].get(k, 0)
                        + truth["launches"].get(k, 0) for k in FSDP_KERNELS},
           "rows": res["rows"], "seconds": time.perf_counter() - t0}
    log(tag, f"one SGD step at lr 1, each leaf's gradient: {json.dumps(out)}")
    bad = {k: (v, bar[k]) for k, v in sharded.items() if v > bar[k]}
    if bad:
        raise AssertionError(f"{tag}: sharded bf16 gradients farther from the float32 one than "
                             f"the bar: {bad}")
    return out


def fsdp_batches(cfg, b=FSDP_B, s=FSDP_S, steps=2) -> list[dict]:
    """The steps' global batches (``batch_at``, one shard a data rank)."""
    ld = LoaderConfig(cfg.vocab_size, b, s, n_shards=FSDP_MESH[0])
    return [batch_at(ld, i) for i in range(steps)]


def fsdp_run(device, archs=None, b=FSDP_B, s=FSDP_S, tag="fsdp-families") -> dict:
    """``chip_smoke.py --fsdp-families`` (FSDP_FAMILIES) and ``--fsdp``
    (FSDP_DENSE), each in a fresh process: every arch of `archs` (name ->
    (layers, steps, planted fault)) at full width, the unsharded reference
    in this process (files on the host, the card freed), then
    ``fsdp_checks`` on one 2 x 2 mesh of four ranks that serves them all
    (started beside the first reference), with the arch's planted fault;
    the 2-microbatch control (``fsdp_control``) but for the moe (its
    capacity, and so its function, depends on the microbatch's tokens); for
    the archs of FSDP_GRAD_CHECK, ``fsdp_grad_check``. The moe's and the
    hybrid's attention is conditioned (``fsdp_init``). Every flash and SSD
    call of a rank's step 0 is held to its plain version. Logs each arch's
    step wall, collective share and peak a rank."""
    from repro_torch.launch.mesh import make_test_mesh

    archs = FSDP_FAMILIES if archs is None else archs
    t_all = time.perf_counter()
    cuda = device.type == "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip() if cuda else ""
    log(tag, smi)
    if cuda:
        built = _build.build_all()
        log(tag, f"{sorted(built)} built in {time.perf_counter() - t_all:.1f} s")
    out = {"families": {}, "launches": dict.fromkeys(FSDP_KERNELS, 0), "smi": smi}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        pending = pool.submit(make_test_mesh, FSDP_MESH, device=device)
        mesh = None
        try:
            for arch, (depth, steps, fault) in archs.items():
                atag = f"fsdp-{arch}"
                setup = fsdp_family_setup(arch, depth)
                cfg = setup[0]
                n = tree_num_params(T.model_defs(cfg))
                log(atag, f"{cfg.name} x{cfg.n_layers}: {n} params, {4 * n / 1e9:.2f} GB "
                    f"float32; p, mu and nu a rank on {FSDP_MESH}: "
                    f"{12 * n / math.prod(FSDP_MESH) / 1e9:.2f} GB")
                batches = fsdp_batches(cfg, b, s, steps)
                t1 = time.perf_counter()
                with tempfile.TemporaryDirectory() as d:
                    ref = fsdp_reference(device, setup, batches, d, atag)
                    control = (None if cfg.family == "moe"
                               else fsdp_control(device, setup, batches, ref, atag))
                    if mesh is None:
                        mesh = pending.result()
                        log(tag, f"{mesh.n} ranks on {device.type} up "
                            f"{time.perf_counter() - t0:.1f} s after the phase started")
                    res = fsdp_checks(device, setup, ref, batches, mesh, atag, fault=fault)
                res["reference"] = {k: ref[k] for k in ("rows", "peak_gb", "seconds", "launches")}
                res["control"] = control
                for k in FSDP_KERNELS:
                    out["launches"][k] += res["launches"][k] + ref["launches"].get(k, 0)
                if arch in FSDP_GRAD_CHECK:
                    res["grad_check"] = fsdp_grad_check(device, arch, depth, batches[0], mesh)
                    for k, c in res["grad_check"]["launches"].items():
                        out["launches"][k] += c
                res["seconds"] = time.perf_counter() - t1
                out["families"][arch] = res
                log(atag, f"launches {res['launches']} a rank's steps summed over the ranks, "
                    f"{ref['launches']} unsharded; done in {res['seconds']:.1f} s")
        finally:
            close_mesh(mesh or pending.result(), tag)
    out["seconds"] = time.perf_counter() - t_all
    log(tag, f"launches {out['launches']}; all done in {out['seconds']:.1f} s")
    return out


def profile_subprocess(flag: str, *args: str, timeout: float = 900) -> dict:
    """``chip_smoke.py <flag> [args]`` in a fresh process on the same card;
    its JSON result (the last line of its output)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), flag, *args], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=timeout)
    tag = flag.removeprefix("--")
    log(tag, f"rc={r.returncode} in {time.perf_counter() - t0:.1f} s\n{r.stdout.strip()}")
    if r.returncode != 0:
        raise AssertionError(f"{tag} failed:\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def side_by_side(tag: str, *flags: str) -> list[dict]:
    """``profile_subprocess`` of each flag, all at once (their results in
    order). For phases whose checks do not time the card and whose memory
    fits together: their own step timings are then taken beside each
    other's (run a flag alone to time it); the kernels line's times come
    from phases run alone. Logs the card's peak memory in use (every
    process on it, sampled every 0.5 s) while they run."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    peak, done = [0], threading.Event()

    def sample():
        while not done.wait(0.5):
            free, total = torch.cuda.mem_get_info()
            peak[0] = max(peak[0], total - free)

    watcher = threading.Thread(target=sample, daemon=True)
    watcher.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(len(flags)) as pool:
            out = [f.result() for f in [pool.submit(profile_subprocess, flag) for flag in flags]]
    finally:
        done.set()
        watcher.join()
    log(tag, f"{', '.join(flags)} side by side, done in {time.perf_counter() - t0:.1f} s; "
        f"the card's peak in use {peak[0] / 1e9:.2f} GB")
    return out


def main() -> int:
    """Run every phase; the last stdout line is the result object."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{kind} x{count}")

    t0 = time.perf_counter()
    built = _build.build_all()  # one nvcc per source, all started together
    for name in _build.SIGNATURES:
        _build.load_library(name)
    log("build", f"{sorted(built)} built, {len(_build.SIGNATURES)} loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_report(built)
    log("build", "ptxas (the flash and decode kernels at head_dim 64, 128 and 256, block_topk, "
        "sparse_axpy, the ssd kernels at hd 64): " + json.dumps(
            {k: v for k, v in ptxas.items()
             if (k.startswith("flash_") and (k.endswith((",64>", ",128>", ",256>"))
                                             or ",64," in k or ",128," in k or ",256," in k))
             or k.startswith(("block_topk", "sparse_axpy"))
             or (k.startswith("ssd_") and k.endswith("<64>")) or "ssd_bwd_finish_kernel" in k}))
    for d in (64, 128, 256):
        log("build", f"dynamic shared memory a block at head_dim {d}, bytes: "
            f"{json.dumps(flash_smem_bytes(d))}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (b, nc, *rest) in SSD_MAIN.items():
        log("build", f"ssd plan at the {label} shape: {json.dumps(ssd_plan(b * nc, *rest, sms))}")

    t0 = time.perf_counter()
    rcv1, news20 = DATASET_PRESETS["rcv1"], DATASET_PRESETS["news20"]
    main_shape = (10, rcv1["d"], rcv1["k"])
    # + init_state's phibar scatter: all q*k = 7,400 entries of a node at
    # once, into D = d + 3 (AUC)
    init_shape = (10, rcv1["d"] + 3, 100 * rcv1["k"])
    errs = kernel_parity(dev, [main_shape, init_shape, (3, 1003, 9), (10, 2000, 1200)])
    times = time_kernels(dev, *main_shape)
    errs["block_topk"] = topk_parity(dev)
    times["block_topk"] = time_topk(dev)
    log("kernels", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    total, _ = slice_runs(dev, rcv1["d"], rcv1["k"])
    log("slice", f"launches {total}; done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    profile_steps(dev, rcv1["d"], rcv1["k"])
    log("profile", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    widest_run(dev, news20["d"], news20["k"])
    log("widest", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cfg = get_config("minitron-8b")
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log("model", f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count()} params, {nbytes / 1e9:.2f} GB on the card, "
        f"drawn in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    _, decode_main, serve_launches = serve_phase(dev, cfg, params)
    log("serve", f"launches {serve_launches}; done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    errs.update(attention_parity(dev, decode_main))
    errs["flash_attention_bwd"] = flash_bwd_parity(dev)
    busiest = decode_main[4].tolist()
    del decode_main  # holds views of the serve pool
    log("attention", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    times["decode_attention"] = profile_subprocess("--decode-profile", json.dumps(busiest))
    log("decode-profile", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    aprof = profile_subprocess("--attention-profile")
    times["flash_attention"] = aprof["flash_attention"]
    times["flash_attention_bwd"] = aprof["flash_attention_bwd"]
    log("attention-profile", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    _, score_launches = score_phase(dev, cfg, params)
    log("score", f"launches {score_launches}; done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    conditioned_phase(dev, cfg, params)
    log("conditioned", f"done in {time.perf_counter() - t0:.1f} s")

    # the 22 GB of serve weights and the serve phases' pools: the Schedulers
    # and their decode_fn closures form reference cycles, so collect them
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("train", f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the train state")
    t0 = time.perf_counter()
    _, train_launches, state = train_phase(dev)
    log("train", f"launches {train_launches}; steps done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_on_off(state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    log("train", f"on vs off done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    # two resume checks that time nothing: their child processes run side by side
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for done in [pool.submit(launcher_phase), pool.submit(gossip_launcher_phase)]:
            done.result()
    log("launcher", f"with the gossip example, done in {time.perf_counter() - t0:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    errs.update(ssd_parity(dev))
    log("ssd", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    scfg = ssm_config()
    sparams = T.init_params(scfg, seed=0, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(sparams))
    log("ssm-model", f"{scfg.name}: {scfg.n_layers} layers, d_model {scfg.d_model}, "
        f"{scfg.ssm_heads} heads of {scfg.ssm_head_dim}, state {scfg.ssm_state}, "
        f"{tree_num_params(T.model_defs(scfg))} params, {nbytes / 1e9:.2f} GB on the card, "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, ssm_serve_launches = ssm_serve_phase(dev, scfg, sparams)
    log("ssm-serve", f"launches {ssm_serve_launches}; done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, ssm_score_launches = ssm_score_phase(dev, scfg, sparams)
    log("ssm-score", f"launches {ssm_score_launches}; done in {time.perf_counter() - t0:.1f} s")
    del sparams
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, ssm_train_launches = ssm_train_phase(dev)
    log("ssm-train", f"launches {ssm_train_launches}; done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    prof = ssm_profile_subprocess()
    times.update(prof["ssd"])
    log("ssm-profile", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hybrid = profile_subprocess("--hybrid")
    log("hybrid", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe, encdec = side_by_side("moe-encdec", "--moe", "--encdec")
    t0 = time.perf_counter()
    options = profile_subprocess("--options")
    log("options", f"done in {time.perf_counter() - t0:.1f} s")
    # --solvers launches no kernel of the line below; each pair holds one
    # rcv1-width Newton solve of z* (17.8 GB) at a time at most
    # with the within-pod step of the moe, ssm and hybrid families: the
    # three together peak below 60 GB of the card
    _, faults, fsdp_families = side_by_side("solvers-faults-families", "--solvers", "--faults",
                                            "--fsdp-families")
    # with the dense within-pod step: its reference peaks at 35.5 GB, the
    # pair at 13.2 GB
    sweep, sharded, fsdp = side_by_side("sweep-sharded-fsdp", "--sweep", "--sharded", "--fsdp")
    t0 = time.perf_counter()
    launch = profile_subprocess("--launch")
    log("launch", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the ranks' two peaks take 75.5 of the card's 85 GB
    log("gossip-ranks", f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved in this process before the "
        "gossip states")
    gossip = profile_subprocess("--gossip-ranks")
    log("gossip-ranks", f"done in {time.perf_counter() - t0:.1f} s")

    total["decode_attention"] = serve_launches["decode_attention"]
    # flash_attention runs on two main paths here: the score phase and the
    # train steps; its backward on the last; the gossip steps (local and over
    # ranks) in --gossip-ranks below
    total["flash_attention"] = (score_launches["flash_attention"]
                                + train_launches["flash_attention"])
    total["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
    # ssd_chunk runs on three main paths: the ssm serve prefills, the ssm
    # score phase and the ssm train steps; its backward on the last
    total["ssd_chunk"] = (ssm_serve_launches["ssd_chunk"] + ssm_score_launches["ssd_chunk"]
                          + ssm_train_launches["ssd_chunk"])
    total["ssd_chunk_bwd"] = ssm_train_launches["ssd_chunk_bwd"]
    # and the hybrid's serve, score, long_500k and train paths (--hybrid),
    # the moe and encdec families' serve, score and train paths (--moe,
    # --encdec), llama3-405b's bf16 train steps and the flash stack beside
    # minitron-8b's blockwise prefill (--options), the fault, schedule,
    # churn and resume paths (--faults), the batched sweeps at B*N rows
    # (--sweep), the examples and the dry run's fitting cell on the card
    # (--launch), the ranks of the sharded backend (--sharded), the
    # gossip steps, local and over 2 ranks (--gossip-ranks: block_topk's
    # only path), and the within-pod step on a 2 x 2 mesh of ranks with its
    # unsharded reference: gemma2-2b (--fsdp), mamba2-1.3b, zamba2-1.2b and
    # qwen2-moe-a2.7b (--fsdp-families)
    for name, n in (*hybrid["launches"].items(), *moe["launches"].items(),
                    *encdec["launches"].items(), *options["launches"].items(),
                    *faults["launches"].items(), *sweep["launches"].items(),
                    *launch["launches"].items(), *sharded["launches"].items(),
                    *gossip["launches"].items(), *fsdp["launches"].items(),
                    *fsdp_families["launches"].items()):
        total[name] += n
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": total[name],
         "max_abs_err": errs[name], **times[name]}
        for name in ("sparse_dot", "sparse_axpy", "flash_attention", "decode_attention",
                     "flash_attention_bwd", "block_topk", "ssd_chunk", "ssd_chunk_bwd")
    ]
    log("all", f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    PROFILES = {"--ssm-profile": ssm_profile, "--attention-profile": attention_profile,
                "--hybrid": hybrid_run, "--moe": moe_run, "--encdec": encdec_run,
                "--options": options_run,
                "--solvers": solvers_run, "--faults": faults_run,
                "--sweep": sweep_run, "--launch": launch_run, "--sharded": sharded_run,
                "--gossip-ranks": gossip_ranks_run,
                "--fsdp": lambda dev: fsdp_run(dev, FSDP_DENSE, tag="fsdp"),
                "--fsdp-families": fsdp_run,
                "--topk-profile": topk_profile,
                "--gossip-profile": lambda dev: gossip_phase(dev, topk_rows=True)[0],
                "--decode-profile": lambda dev, *a: decode_profile(dev, *map(json.loads, a))}
    if len(sys.argv) >= 2 and sys.argv[1] in PROFILES:
        if not torch.cuda.is_available():
            sys.exit(1)
        print(json.dumps(PROFILES[sys.argv[1]](torch.device("cuda"), *sys.argv[2:])))
        sys.exit(0)
    sys.exit(main())
