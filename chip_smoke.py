#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``merv_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--max-new-tokens 32] [--flash-only | --small-only | --tower-only |
                           --int8-only | --layer-norm-only | --decode-step-only | --engine-only | --int8-serving-only |
                           --families-only | --zoo-only | --pretrain-only | --sp-only | --tp-only |
                           --train-parallel-only | --bench-only]

``--flash-only`` stops after phase 3's K2 and K3 cases, ``--small-only``
after its K1 and B3 cases, ``--tower-only`` after the towers' B3, B5 and B6
cases, ``--int8-only`` after K4's and K5's, ``--layer-norm-only`` after
K6's; each prints them as one JSON
line, with no result line: a quick way to compare two versions of those
kernels within one call. ``--engine-only`` and ``--int8-serving-only`` run
phase 4e or 4f alone after the build and print their numbers the same way;
``--decode-step-only`` times the B = 1 decode step of Llama-2-7B's widths at
8 layers, bf16 and int8 (``decode_step_probe``), for ``chip_ab.sh``.
``--families-only`` runs phase 3's cases at the LLM families' shapes, the
packed-layout check and phase 4g alone and writes them to
``chiprun_out/families.json``; ``--zoo-only`` runs K1's and B3's head-dim-72
cases and phase 4h alone and writes them to ``chiprun_out/zoo.json``; ``--pretrain-only`` runs B6's head-dim-72 cases and
phase 5b alone and writes them to ``chiprun_out/pretrain.json``;
``--sp-only`` runs phases 4i and 4j (their ranks share one world) and writes
them to ``chiprun_out/sp.json``; ``--tp-only`` runs phase 3's cases at 4j's
shard shapes and phase 4j alone and writes them to ``chiprun_out/tp.json``;
``--train-parallel-only`` runs phase 5c alone and writes it to
``chiprun_out/train_parallel.json``; ``--bench-only`` runs phase 6 alone and
writes it to ``chiprun_out/bench.json``.
``--small-only`` covers K1's and B3's head-dim-72 cases too.

Phases, each of which fails the run (non-zero exit, no result line) if it fails:
1. device: the card's name and ``nvidia-smi`` power limit; no CUDA -> exit 2.
2. build: ``nvcc`` compiles every ``merv_tpu_torch/csrc/*.cu`` for sm_90a;
   for every library, ``ptxas -v``'s
   registers, spills and shared memory and, where ``cuobjdump`` exists, the
   counts of ``HGMMA`` (wgmma), ``HMMA`` (mma.sync), ``UTMALDG`` (TMA load)
   and ``UBLKCP`` (1-D bulk copy) in their SASS, per library and per kernel
   instance (K1 and B3 are each built for head dims 64 and 72).
3. kernels: each hand-written kernel against its plain PyTorch version at the
   main paths' shapes (bf16, inputs from a numpy seed), with max/mean abs
   error against a stated tolerance and CUDA-event times of the kernel, the
   plain version and one PyTorch library call (SDPA, forward + backward for
   the backward kernel: a yardstick only, the port never calls it), beside
   the shape's lower bound on this card; for K1, K2, K3 and B3 also the
   device time of the kernel and of SDPA from ``torch.profiler``, and for K1,
   B3, B5 and B6, SDPA beside them and B6's composed half-layer the
   graph-replay time (``graph_ms``: 20 calls in one CUDA graph, which host
   launch cost cannot hide). The flash forward's
   log-sum-exp is held row by row against the plain version's; the backward
   kernel is held twice: against the plain backward on the forward kernel's
   o and lse, and against the plain backward on the plain forward's, and two
   of its calls on the same inputs must give the same bits. The towers' opt-in
   kernels (B3 ``small_attention``, B5 ``packed_temporal_attention``, B6
   ``fused_vit_attn_block``) at merv-base's shapes, with SDPA (B3, B5; for
   B5 also the backend SDPA picks and each backend's time) or the default
   route's composed attention half-layer (B6) as the yardstick, and planted
   faults that the same check must catch. B6 is held end to end and stage by
   stage (``hold_fused``), and held and timed by graph replay with its
   whole-head and its key-tiled attention stage each forced, interleaved,
   where both take the shape;
   under ``--tower-only`` also its launches' device time by kernel
   (``kernel_device_ms``). K2 also at the shared-prefix suffix prefill (8
   ragged suffixes in a 64-token bucket at ``q_offset`` 1025), held and
   graph-timed beside SDPA. K4 (``int8_linear``) at Llama-2-7B's four weight
   shapes and 1, 4, 8 and 36 rows of x and at an output width that is not a
   multiple of its tile, beside the bf16 model's ``F.linear`` on the same
   shape; K5 (``decode_attention``) at B = 1 over 1,120 cache rows (bf16 and
   int8), 4 slots over 2,058 rows with ragged lengths and the scratch row,
   the verify at Tq = 5 and 9 with [B] offsets, GQA 32 -> 8 and D = 64, beside
   SDPA on the bf16 cache (after the dequantization for int8); a wrong scale
   column in K4 and an off-by-one causal offset in K5 must be caught. K4, K5
   and their yardsticks are graph-timed warm and L2-cold (rotating through
   copies of the inputs larger than the L2), with the plan each wrapper picks
   and the residency it read, and one call of each must capture as one
   kernel node (``kernel_launches``). Then the same at the shapes of every
   LLM family phase 4g serves (``family_kernel_cases``): K4 at each packed
   serving Linear (qkv, gate/up, o, down, lm_head of Llama-2-7B / 13B,
   Llama-3 / 3.1-8B, Qwen-2.5-7B / 3B: N from 2,560 to 152,064, K 2,048 to
   18,944) at 1, 4 and 36 rows; K5 at GQA groups 7, 8, 4 and 1 (decode) and at
   the verifies whose group x Tq rows cross a 16-row unit inside a head (21,
   35, 24, 20 rows), bf16 and int8; K2 at the 28 -> 4, 16 -> 2 and 40-head
   prefills and Qwen-2.5-7B's 28 -> 4 suffix prefill, beside SDPA. Then at
   tensor-parallel serving's shard shapes (``tensor_kernel_cases``): K2 at a
   tensor = 2 rank's 16 heads of Llama-2-7B's prefill, K4 at its unpacked
   shards (q/k/v 2,048 x 4,096, o 4,096 x 2,048, gate/up 5,504 x 4,096, down
   4,096 x 5,504, the lm_head's 16,032 columns; down at tensor = 4's 2,752
   inputs) at 1 and 4 rows, K5 at 16 heads (bf16 and int8, decode, the
   engine's slots, the verify at 3 rows). K1 and B3
   at SigLIP so400m's head dim 72 (``head_dim_72_cases``: [16, 16, 256, 72],
   ragged T = 229, T = 512, and B3's GQA [4, 16 -> 4, 256, 72]) beside SDPA,
   graph-timed, where a fault that ignores head-dim columns 64-71 (and, on
   the GQA case, B3's kv-head fault) must be caught. B6 at head dim 72
   (``fused_d72_cases``: so400m's layer at [16, 256, 1152] H 16, ragged
   S = 229, S = 257 and 513, where the stages switch at head dim 64, and
   [256, 256, 1152], phase 5b's align micro-batch),
   each call counted under its own counter, held end to end and stage by
   stage, three planted faults caught (the q bias dropped, the scores
   unscaled, the softmax scale of head dim 64), timed by CUDA events and
   graph replay beside the default route's composed half-layer, and on
   so400m's shape its device time by launch. K6 (``layer_norm``) at the
   towers' LayerNorm shapes (``layer_norm_cases``: LanguageBind's rows at the
   align micro-batch and at one served video, ViViT's at the micro-batch,
   so400m's), held and within one bf16 ulp of its plain version, graph-timed
   beside the plain formula, one ``F.layer_norm`` call and its bytes bound.
4. serving path: merv-base at full width (four towers at 224 px with
   [16, 16, 32, 16] frames, 1024 visual tokens, Llama-2-7B with 32 layers in
   bf16) on random weights from a seeded generator on the card; serves 3
   requests through ``MERV.generate`` and one batched ``generate_ids``
   (B=2: one shorter prompt, one text-only row), with the kernels' launch
   counters zeroed just before and read just after; then reruns request 0's
   prefill with ``impl="plain"`` and every norm on the plain formula
   (``plain_norms``) and holds the spliced input embeddings and the
   last-position logits against it, holds each kernel call of that prefill
   (K1, K2, K6) against its plain version on the call's own inputs, compares the
   greedy tokens, and reports what both checks give for a few planted
   kernel faults. Every request decodes through its decode runner's CUDA
   graph (the T=1 step captured once per shape; ``decode_capture_s`` apart
   from ``decode_s``); from request 0's prefill the graph's tokens and step
   logits are held against the eager loop over the same step function, both
   loops are timed, and one eager step and one replay are profiled (device
   ms, kernels, idle share); a sampled decode from one seed is compared too.
4a. tower routes: each tower of that model at merv-base's batch shapes under
   the default route and under each of the towers' switches
   (``MERV_TPU_TOWER_ATTN=xla`` / ``xla_kt``, ``MERV_TPU_TEMPORAL_KERNEL=1``,
   ``MERV_TPU_FUSED_VIT_BLOCK=1``): ms per tower, the output against the same
   route with ``impl="plain"`` and plain norms, every B3/B5/B6/K6 call held
   against its plain version (B6 stage by stage), launches per tower;
   planted B5 and B6 faults must be caught.
4b. two more requests: request 0 served with ``MERV_TPU_TOWER_ATTN=xla`` and
   ``MERV_TPU_TEMPORAL_KERNEL=1`` (B3, B5, K2), and with
   ``MERV_TPU_FUSED_VIT_BLOCK=1`` (B6, K2), launches as predicted in
   ``SWITCHED_REQUESTS``, each held against its plain rerun as request 0 is.
4c. a loaded run directory, once phase 4's model is freed: writes
   ``runs/chip_smoke_quickstart/`` (config.json with merv-full's model dict,
   fp32 projectors and fusion from a seeded generator through the port's
   ``save_checkpoint``), loads it with ``load_vid(..., allow_random_weights=True)``
   (towers and LLM random from the port's seeded generator: the repository
   holds no weights), checks projectors and fusion bit-identical and fp32, towers
   and LLM bf16 on the card, then serves one ``generate`` on
   ``assets/video_demo.mp4`` with the launch counters zeroed just before and
   read just after (``LOADED_REQUEST_LAUNCHES``), and holds it against its
   plain rerun as request 0 is. It prints which decoder opens the file
   (``{"video_decode": ..., "frames_from": ...}``); where none does, the
   request takes seeded synthetic frames of the decoded shape. The run
   directory is deleted at the end.
4d. the evaluation path: merv-full's run directory (as 4c writes it) at
   ``runs/chip_smoke_eval/``, served by the port's drivers through their
   command lines with 64 new tokens: ``eval_mcq`` on ``eval_data/dummy_mcq``
   (naive at batch 2, likelihood at batch 2, naive with
   ``--share_video_prefix`` at batch 2) and ``eval_openended`` on
   ``eval_data/dummy_openended_scaled`` (32 questions on 4 videos, batch 8,
   ``--serving_passes 2``); every question must get a ``pred``, no group or
   item may fail, and K1 / K2 launches must be as predicted
   (``EVAL_RUNS``). Then ``generate_batch_shared`` against
   ``generate_batch`` on scene_0's 8 questions: each row's last-position
   logits of the suffix prefill held against the full prefill's, greedy
   agreement reported, launches as predicted.
4e. the serving engine: merv-full's run directory (as 4c writes it) at
   ``runs/chip_smoke_serve/``, 64 new tokens, 4 slots over a 2,048-token
   budget. In this process: (a) the engine's decode chunk (plain, and the
   verify at gamma 4) replayed as its CUDA graph against the same chunk
   function run eagerly from the same state, greedy tokens identical; the
   plain chunk's and the verify chunks' (gamma 2, 4, 8) ms per step by graph
   replay, their ratios being the H100 ``_SPEC_COST_RATIO``; (b) the engine's
   greedy tokens against ``MERV.generate`` on 6 requests (agreement
   reported); (c) the speculative engine's against the plain engine's
   (agreement and tokens per verify step reported). Then
   ``python -m merv_tpu_torch.cli.serve`` three times in fresh processes
   (``SERVE_RUNS``: prefix sharing on, off, and ``--speculative 4``) on
   ``eval_data/dummy_openended_scaled``'s 32 questions, 4 text-only requests
   and one naming a missing video: every request must get a line, only the
   missing video's with ``finish_reason: "error"``, and K1 / K2 launches
   must be as predicted from the engine's counts
   (``engine_predicted_launches``). Requests/s, tokens/s, TTFT p50, slot
   utilisation, prefill stall share, capture seconds and peak memory are
   printed per run. Every decode chunk now runs K5 on the bf16 slot cache;
   its launches are predicted from the engine's forwards too.
4f. int8 serving: merv-full's run directory (as 4c writes it) loaded with
   ``load_vid(quantize_llm=True)``: (a) one ``MERV.generate`` on the demo
   video with ``kv_cache_dtype="int8"``, K1 / K2 / K4 / K5 launches as
   predicted, every K4 and K5 call of one eager decode step held against its
   plain version, the decode graph's tokens against the eager loop's and its
   ms per step beside phase 4's bf16 step, greedy agreement with 4c's bf16
   request reported (random weights: not gated); (b) the engine's plain and
   gamma-4 chunk graphs on the int8 model and int8 slot cache against the
   eager chunk, ms per step; (c) one ``cli/serve.py --quantize_llm --int8_kv``
   process with prefix sharing on 4e's 37 requests, every request answered,
   only the missing video failing, launches as predicted from the engine's
   counts; (d) int8 weight bytes and peak memory.
4f'. the packed serving layout (``packed_check``): merv-full's run directory
   loaded with ``pack_llm=True`` and ``False`` side by side, bf16 and int8: the
   packed prefill's logits held against the unpacked one's (relative L2),
   greedy agreement reported, both through the same decode graph (tokens
   equal to the eager loop's), K4 launches a step (129 packed, 225
   unpacked), one profiled replay's cuBLAS GEMMs, and the two steps timed in
   interleaved rounds.
4g. the LLM families (``families_path``), each from a run directory with
   merv-full's towers and projectors and the family's LLM at full width and
   depth on random weights, loaded by ``load_vid``: Qwen-2.5-7B-Instruct
   (28 layers, 28 -> 4 heads, q/k/v biases, a 152,064-row head, fp16 storage,
   no BOS) in full: one ``generate`` on the demo video with launches as
   predicted, held against its ``impl="plain"`` rerun and call by call, the
   decode graph against the eager loop with its ms per step and one profiled
   replay; the step again with the weights stored in fp16 and cast at every
   use (same tokens, and the copies' cost); then ``quantize_llm=True``: an
   int8-cache request with every K4 / K5 call of one eager step held, the
   engine's plain and gamma-4 chunk graphs against the eager chunk, and one
   ``cli/serve.py --quantize_llm --int8_kv`` process on 4e's 37 requests.
   Llama-3.1-8B-chat (GQA 4, a 128,256-row head), Qwen-2.5-3B-Instruct (GQA
   8, tied head) and the LLaVA-1.5-13B reproduction (Vicuna-13B: 40 layers,
   hidden 5,120) one request each with the same request checks and decode
   step. Every family runs at its full depth; peak memory per model.
4h. the vision zoo (``zoo_path``), each from a run directory loaded by
   ``load_vid`` with merv-full's Llama-2-7B at full width and depth on random
   weights: Z1, Hiera-base-plus (32 frames, 2 clips), the pooled SigLIP
   so400m (its 27 layers on K1 at head dim 72), DINOv2 and LanguageBind
   through ``attntv+gelu-mlp`` and ``cross_attention_avg_lq_pe``; Z2,
   merv-full's towers through ``3dconv+fused-gelu-mlp`` and
   ``concat_channel_ln``. Each: one ``generate`` on the demo video with the
   request checks of 4g (launches as predicted, ``ZOO_TOWER_LAUNCHES``; held
   against its plain rerun and call by call; the decode graph against the
   eager loop; peak memory and the phase split). On Z1 also Hiera-base-plus
   and so400m timed on the default route and on ``MERV_TPU_TOWER_ATTN=xla``,
   so400m also on ``MERV_TPU_FUSED_VIT_BLOCK=1`` (B6 at head dim 72, 27
   launches, its output against the default route's), and, on its tower
   features, every resampler and fusion at full width
   (``zoo_projector_sweep``: finite, of the expected shape, its ms).
4i. sequence-parallel serving (``sp_path``, also ``--sp-only``): (a) K5 with
   its LSE on every shard of a 2,048-row Llama-2-7B cache split 2 and 4 ways
   (bf16 and int8, decode and the verify's 5 rows, shards wholly after the
   queries), at (c)'s shapes (3 rows over 553-row shards, 4 slots over
   1,025-row shards at per-slot offsets) and at GQA 32 -> 8, each held
   against its plain version and the shards merged by LSE against unsharded
   K5, and K5 with and without its LSE at 1,120 rows by graph replay in
   turns; then the two ranks of (c) start while (b) the ring
   over 2 and 4 in-process ranks, natural and zigzag, forward and backward at
   ``[1, 32, 8192, 128]`` and GQA 32 -> 8, is held against K2 / K3 on the
   whole sequence with the launches its blocks predict; (c)
   ``eval_openended`` on merv-full's run directory at sp = 1 in this process
   and at ``--mesh_seq 2`` as two ranks on the card over gloo
   (``torch.distributed.run`` of this script with ``--sp-worker``), group
   path and ``--use_engine``: each rank's launches must show the sharded
   route (K5 with LSE, no unsharded K5), its decode cache about half of
   sp = 1's bytes, its first K5 call with its LSE (kept with its inputs)
   held against the plain version after the counts are read, the first-token
   logits within LOGITS_REL_TOL of sp = 1's and, on the group path, each
   decode step's logits too, up to the first token that differs (random
   weights leave near ties, and pick ids past the byte tokenizer's range,
   whose text is mostly empty: tokens are compared, not text).
4j. tensor-parallel serving (``tensor_checks``; in 4i's world: its two ranks
   go on to 4j once their eval runs are done, and this process runs 4j's
   world-1 reference once its sp = 1 runs are done): merv-full's run
   directory (4i's) loaded by ``load_vid(mesh=)`` at tensor = 2 over gloo
   (packing off, the LLM quantized where asked and cut to the rank's Megatron
   shards, towers, projectors and fusion whole), and in this process at world
   1 unpacked; each serves ``MERV.generate`` (16 new tokens) on the demo
   video and the engine (3 slots, the three ``TENSOR_QUESTIONS``, 8 new
   tokens, one chunk, run eagerly on both sides so that each step's logits
   can be read) at gamma 0 and 2, then the same run directory with
   ``quantize_llm=True`` through the engine on the video's shared prefix.
   World 1 also serves the first token three more times with o's and down's
   GEMMs cut at half their input as tensor = 2 cuts them: the two bf16
   partials added (the rounding the ranks' sums bring, a control) and two
   planted faults (a skipped sum, the shards swapped). Fails unless each rank
   holds ``TENSOR_SHARE`` of world 1's LLM weight bytes (bf16 and int8) and
   decode cache bytes, one decode step makes 2 L + 1 sums and 1 gather, every
   run's K1 / K2 / K4 / K5 launches are its counts' prediction (unpacked
   Linears), the control reads below ``TENSOR_LOGITS_REL_TOL`` and each planted
   fault above it, and in every run (the request, each engine run, the int8
   engine against world 1's int8 engine) each request's first-token logits
   and every decode or verify step's logits up to its first differing token
   are within ``TENSOR_LOGITS_REL_TOL`` of world 1's; only rank 0 returns the
   engine's results. Greedy agreements and the walls against world 1's are
   reported (the ranks run eagerly: gloo's collectives cannot be captured).
5. training path: merv-base's align stage at full width, Llama-2-7B cut to
   ``TRAIN_LLM_LAYERS`` = 16 of its 32 layers to keep the script within its
   time limit (phase 5b trains the align stage at full depth) (fp32
   projectors and fusion trained, bf16 towers and LLM frozen) through
   ``get_train_strategy`` -> ``run_setup`` -> ``run_training``: 3 steps of
   global batch 32 (per-device batch 16, accumulation 2), remat on, the loss
   streamed in 256-token blocks, on seeded uint8 frames normalised on the
   card and ByteTokenizer captions, launch counters zeroed just before and
   read just after. Checks: finite losses; trainables unchanged by step 1
   (lr 0) and moved by step 3; towers and LLM bit-identical; launches per
   micro-step as predicted; on one micro-batch of 1, the loss and the
   trainables' gradients against the all-plain path (norms included),
   every forward-kernel call's output and log-sum-exp, every backward-kernel
   call and every K6 call held against the plain versions on the call's own
   inputs, and three planted faults
   (two of the backward, one of the log-sum-exp) that these checks must
   catch. One more micro-step of the
   per-device batch runs under ``torch.profiler`` for the device time by
   kernel group and the device's idle share.
5b. the pretrain entry point (``pretrain_path``): ``cli/pretrain.py``'s
   ``pretrain()`` in process under ``MERV_TPU_FUSED_VIT_BLOCK=1`` on a
   dataset written under ``runs/`` (align and chat JSONs, video entries on
   copies of the demo video; seeded synthetic frames where no decoder opens
   it, and the phase prints which): align (merv-full with SigLIP ViT-B/16
   swapped for the pooled so400m, Llama-2-7B at full width and depth, 2 steps
   at per-device batch 16 with accumulation 2, a checkpoint every step, the
   periodic ones async), finetune (the align checkpoint discovered beside it,
   the LLM cut to one layer at full width, 2 steps at per-device batch 8),
   then that finetune resumed from its step-1 checkpoint. Each run: launches
   as worked out from the configs (B6 at head dims 64 and 72 counted apart,
   K2, K3) with the counters zeroed just before its loop and read just after,
   finite losses, frozen modules' bits unchanged and trainable ones moved,
   ``latest-checkpoint`` on a directory with its meta.json. After the counts
   were read: B6 held stage by stage, with its planted faults caught, on the
   inputs of its first call at each shape of the first micro-step (so400m's
   [256, 256, 1152] at head dim 72 in the align run, the other towers' at
   64); the first micro-step's loss against the same micro-batch and weights
   with the switch off within PRETRAIN_LOSS_REL_TOL, and the planted scale of
   head dim 64 at so400m's layers outside it. The finetune
   starts from the align projectors and the resume trains step 2 alone. Step
   and micro-step times, the async saves' copy, write and wait.
5c. multi-rank training (``train_parallel_path``, also ``--train-parallel-only``):
   ``python -m torch.distributed.run --nproc_per_node 2`` of this script with
   ``--train-parallel-worker``, two ranks on the card over gloo (NCCL refuses
   two ranks on one card), each run on a fresh merv-base (the registry's
   factories on random weights from one seed, as ``cli/pretrain.py`` builds
   it) with Llama-2-7B at full width, its depth cut so that the two ranks and
   this process's world-1 reference share the card (``TP_FINETUNE_LAYERS``,
   ``TP_ALIGN_LAYERS``), on one global batch of ``TP_GLOBAL_BATCH`` whose rows
   hold unequal label counts; while they run, this process computes the same
   runs at world 1, and ``cli/memory_proof.py`` traces merv-full's finetune
   at 7B over 8 fake ranks on the host. (a) which collectives gloo takes on
   CUDA tensors; (b) ``fsdp-full-shard`` finetune over fsdp = 2, 2 steps of
   one micro-batch: step 1's loss and grad norm against world 1's within
   ``TP_LOSS_REL_TOL`` / ``TP_NORM_REL_TOL`` and planted faults (each rank's
   own token mean averaged, one rank's shards' norm) outside them, the same
   start digest of the trainables on every rank, each rank's parameters and
   AdamW moments 0.48-0.52 of world 1's bytes, launches as ``tp_predicted``
   gives them, step 2's loss and norm against world 1's step 2 within
   ``TP_STEP2_REL_TOL``, and the step-1 checkpoint the ranks wrote held
   against world 1's state after its step 1 (the trainables within
   ``TP_PARAM_REL_TOL``, both AdamW moments by one-device index within
   ``TP_GRAD_REL_TOL``, the step counts; a gather in the other rank order and
   misnumbered moments outside) and resumed by a world-1 strategy, every
   trainable bit-equal to the file; (c) align at ``--mesh_seq 2`` (the zigzag
   ring in every layer) through ``cli/pretrain.py``'s ``pretrain()`` on each
   rank (its mesh, model, sampler by batch coordinate, loader, training loop
   and rank 0's async sharded saves; ``TP_CLI_ARGS``: 2 steps on a dataset
   written under ``TP_ROOT``): the same start digest as world 1's, launches as
   the ring's blocks give them, each rank's first ring K2 (with its LSE) and
   K3 call of the counted window held against the plain versions after the
   counts are read, the projectors' and fusion's gradients on one micro-batch
   of the global batch, taken inside the run before its loop, against world
   1's within ``TP_GRAD_REL_TOL`` (a gather backward that sums the ranks'
   gradients outside it), the same finite losses on both ranks, steps 1 and 2
   logged once and the async step-1 checkpoint and the latest written; (d)
   finetune at ``--mesh_pipe 2``, 2 steps: each rank holding one of the two
   layers (half of world 1's layer bytes), launches of its layer once a
   pipeline micro-batch, step 1's and step 2's loss and norm against world
   1's; (e) the memory proof's per-rank peak by category and whether it fits
   the card. The phase prints its seconds and deletes ``TP_ROOT``.
6. the bench and tooling modules (``bench_path``): each of
   ``merv_tpu_torch/bench/`` once on the card at full width, in a process of
   its own (``BENCH_PARALLEL`` at once: this phase checks them, it does not
   measure them), depth and counts cut through the benches' own ``BENCH_*``
   names (the LLM at ``BENCH_LLM_LAYERS`` = 2): ``decode`` bf16 and with
   ``BENCH_INT8=1 BENCH_INT8_KV=1``, ``train``, ``serving`` (its ``group``,
   ``engine`` and ``spec`` processes), ``breakdown``, ``tower_attn`` over its
   five implementations (in two processes), ``tower_ops`` for DINOv2, ``loader`` with a 2 s
   window, ``vidlm_prefix``'s ``engine_shared`` mode on merv-full's
   random-init run directory (``cli/make_randinit_run.py``'s, written first),
   ``cli/export_towers.py`` on full-width LanguageBind and Hiera checkpoints
   made from the seed (each file's tensors must be its checkpoint's) and
   ``cli/preprocess.py`` on a local llava-v1.5-instruct layout (nothing to
   fetch; OCR-VQA's seeded PNG and GIF images converted). Each process must
   exit 0 and print a result line with the merv_tpu script's keys, every rate
   and time finite and > 0 and the card named, and launches as its shapes
   give them (``bench_expected``: K1 46 and K2 12 + L a multimodal prefill,
   K5 L a decode forward, K4 4 L + 1 a forward with int8 weights, K3 L a train
   step; ``small_attention``, ``fused_vit_attn_block`` or none per tower call
   under ``tower_attn``'s ``xla``, ``fused_block`` and ``xla_kt``).
7. output: ``nvidia-smi`` line, a ``{"kernels": [...]}`` line (``launches``
   from the training path for K1-K3, from the switched request of 4b for
   B3, B5 and B6 and from 4f's request for K4 and K5, ``launches_serving`` from the default serving path,
   ``launches_loaded`` from 4c's request, ``launches_eval`` from each of
   4d's runs, ``launches_engine`` from each of 4e's, 4f's and 4g's serve runs,
   ``launches_families`` from each of 4g's requests, ``launches_zoo`` from
   each of 4h's, ``launches_pretrain`` from each of 5b's runs, ``launches_train_parallel`` from each rank
   of each of 5c's runs, ``launches_tp`` from each of 4j's runs on each rank,
   ``launches_bench`` from each of phase
   6's processes (per serving phase and tower_attn implementation); B6's head-dim-72
   instance as ``fused_vit_attn_block_d72``, its launches from 5b's align run), and
   the last line ``{"ok": true, "device": {...}}``. Details go to
   ``chiprun_out/chip_smoke.json``.

Imports nothing of JAX or of ``merv_tpu``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import hashlib
import io
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import time

# the timers and the bound (from the H100's data-sheet rates) live in the package's benchkit
from merv_tpu_torch.benchkit import (
    bound,
    capture_stream,
    device_ms,
    graph_ms,
    kernel_device_ms,
    nvidia_smi_line,
    time_ms,
)
from merv_tpu_torch.cli.make_randinit_run import MERV_FULL_MODEL
# A kernel's output is held element by element against its plain version:
# |out - ref| <= KERNEL_REL_TOL * (|ref| + mag) + KERNEL_ABS_TOL, where mag is
# the plain version's output on |v|, i.e. sum(p |v|) / l. Kernel and plain
# version each round p to bf16 (at different maxima: an error of at most
# 2**-8 * mag each) and round the output to bf16 (2**-8 * |ref| each), so
# 2**-7 * (|ref| + mag) is the sum of both; it is what a row whose few terms
# cancel needs. The absolute term covers fp32 summation order. The mean error
# must also stay under KERNEL_MEAN_SHARE of the mean limit (about 7e-4 at
# unit-normal inputs, against a typical |o| >= 0.023 at these shapes).
KERNEL_REL_TOL = 2 ** -7
KERNEL_ABS_TOL = 1e-4
KERNEL_MEAN_SHARE = 0.1
# whole path, kernels vs plain versions on the same weights: relative L2
# difference of the spliced input embeddings (towers, projectors, fusion) and
# of the prefill's last-position logits (all of the above plus 32 layers)
EMBEDS_REL_TOL = 2e-2
LOGITS_REL_TOL = 5e-2
# the decode graph against the eager loop over the same step function on the same
# state: the same kernels, so the same bits are expected; where a library picks
# another algorithm under capture, the step logits (fp32 from a bf16 lm_head)
# may differ by bf16 rounding, 2**-8 relative
DECODE_GRAPH_LOGITS_REL_TOL = 2 ** -8
# K2's log-sum-exp against the plain version's, row by row:
# |lse - ref| <= LSE_REL_TOL * (1 + |ref|) where ref is finite, and +inf on
# exactly the rows where ref is +inf (no valid key). Both sum the exponentials
# of the same fp32 scores in fp32, in different orders (about 1e-6 of |lse|);
# the backward recomputes P = exp(S - lse), so an lse off by d scales the
# row's P, and its gradients, by exp(-d).
LSE_REL_TOL = 1e-4
LSE_PLANTED_OFFSET = 0.05
# the valid suffix tokens of the 8 rows of K2's suffix-prefill case (a 64-token bucket)
SUFFIX_LENGTHS = (64, 57, 49, 41, 36, 30, 23, 12)
# B6's LN statistics against the plain version's, row by row: fp32 sums of
# the same bf16 row in different orders (about 1e-7 relative)
STATS_REL_TOL = 1e-5
# K6 launches of one forward of each tower (one a LayerNorm call: bf16 activations of 768, 1,024 or 1,152 columns,
# nothing to differentiate), on the default route and under MERV_TPU_FUSED_VIT_BLOCK=1, whose fused half-layer
# applies norm1 itself: LanguageBind 23 run layers x (norm1, norm2, the temporal norm) + its pre-norm; DINOv2 and
# SigLIP-B the penultimate tap's 23 / 11 layers x 2; ViViT 12 x 2 + the final norm; the pooled so400m 27 x 2 + the
# final norm + the MAP head's; Hiera-B+ none (its stages are 112-896 wide). TOWER_LN: the merv set's, a video
TOWER_NORMS = {"languagebind-video-noclass": (70, 47), "dinov2-video-all-tokens": (46, 23),
               "vivit-google-b-all-no-cls-16frames": (25, 13), "siglip-vit-b16-224px-all-no-cls": (22, 11),
               "siglip-vit-so400m": (56, 29), "hiera-base-plus-video": (0, 0)}
TOWER_LN = sum(TOWER_NORMS[t][0] for t in MERV_FULL_MODEL["video_backbone_ids"])
# training path (merv-base align stage): the recipe's global batch 32 over 3
# steps (the first at lr 0, untimed), the streamed loss's token block, the
# LLM's depth (16 of Llama-2-7B's 32 layers: the cut that keeps the script
# within its time limit; phase 5b trains the align stage at full depth), the
# kernel launches one micro-step makes (K1: 23 DINOv2 + 23 LanguageBind
# layers; K2: 12 ViViT layers + the LLM's layers twice, the forward and its
# recompute under remat; the backward: the LLM's layers; K6: the towers'
# norms), and the limits of the kernels-vs-plain comparison on one micro-batch (relative difference of the
# loss, relative L2 difference of the projectors' and the fusion's gradients)
TRAIN_GLOBAL_BATCH = 32
TRAIN_STEPS = 3
TRAIN_LOSS_CHUNK = 256
TRAIN_LLM_LAYERS = 16
TRAIN_LAUNCHES_PER_MICRO_STEP = {"small_attention_kt": 46, "flash_attention_forward": 12 + 2 * TRAIN_LLM_LAYERS,
                                 "flash_attention_backward": TRAIN_LLM_LAYERS,
                                 "small_attention": 0, "packed_temporal_attention": 0, "fused_vit_attn_block": 0,
                                 "fused_vit_attn_block_d72": 0, "int8_linear": 0, "decode_attention": 0,
                                 "decode_attention_lse": 0, "layer_norm": TOWER_LN}
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 0.1


def hold(out, ref, mag) -> dict:
    """A kernel's output against its plain version ``ref`` (and the plain
    version on |v|, ``mag``): the errors, the limit, and whether both the
    worst element and the mean stay within it."""
    ref, mag = ref.float(), mag.float()
    err = (out.float() - ref).abs()
    limit = KERNEL_REL_TOL * (ref.abs() + mag) + KERNEL_ABS_TOL
    share = (err / limit).flatten()
    i = int(share.argmax())
    r = dict(max_abs_err=err.max().item(), mean_abs_err=err.mean().item(), mean_abs_ref=ref.abs().mean().item(),
             mean_limit=limit.mean().item(), worst_share_of_limit=share[i].item(),
             worst_at=dict(err=err.flatten()[i].item(), ref=ref.flatten()[i].item(), mag=mag.flatten()[i].item()))
    r["mean_share"] = r["mean_abs_err"] / r["mean_limit"]
    r["ok"] = r["worst_share_of_limit"] <= 1.0 and r["mean_share"] <= KERNEL_MEAN_SHARE
    return r


def bf16_ulps(out, ref, mag) -> dict:
    """Two bf16 tensors element by element: the share of them bit-equal and
    the most |out - ref| in bf16 ulps of max(|ref|, mag) (the spacing of bf16
    there, 2**(floor(log2 v) - 7); at 0 that of the smallest normal). ``mag``:
    the magnitude of the terms whose sum was rounded (``layer_norm_terms``):
    where they cancel, a few fp32 ulps of them are many bf16 ulps of the
    result."""
    import torch

    ref32 = ref.float()
    at = torch.maximum(ref32.abs(), mag.float()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(at)) - 7)
    return dict(bit_equal_share=(out.view(torch.int16) == ref.view(torch.int16)).float().mean().item(),
                max_ulps=((out.float() - ref32).abs() / ulp).max().item())


def layer_norm_terms(x, w, b, eps):
    """(|x - mean| + mean(|x|)) * rstd * |w| + |b| in fp32, the magnitude of
    the terms of the plain version's sums: its statistics come from sums in
    another order than the kernel's, so the two may differ by a few fp32 ulps
    of these before the one rounding to bf16. The mean's own error, a few
    ulps of its terms' magnitude mean(|x|), reaches every element of the row
    through x - mean, those at the mean (an output near 0 where b is 0) too."""
    import torch

    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(xf.var(-1, keepdim=True, unbiased=False) + eps)
    return ((xf - mean).abs() + xf.abs().mean(-1, keepdim=True)) * rstd * w.float().abs() + b.float().abs()


def plain_norms():
    """Every LayerNorm through the plain formula for the block: the plain
    side of a kernels-vs-plain comparison, which K6 would otherwise take too
    (``LayerNorm.forward`` has no ``impl`` switch)."""
    import merv_tpu_torch.ops.layer_norm as LN
    from merv_tpu_torch.nn.core import LayerNorm

    return patched((LayerNorm, "forward", lambda m, x: LN.layer_norm_plain(x, m.weight, m.bias, m.eps)))


def held_layer_norms(calls: list):
    """Every K6 call in the block held against the plain formula on the
    call's own inputs and appended to ``calls``: ``hold``'s result with
    ``bf16_ulps``', ok when both hold (at most one bf16 ulp)."""
    import torch

    import merv_tpu_torch.ops.layer_norm as LN

    one_pass = LN.layer_norm_one_pass

    def held(x, w, b, eps):
        out = one_pass(x, w, b, eps)
        ref = LN.layer_norm_plain(x, w, b, eps)
        h = hold(out, ref, torch.zeros_like(ref, dtype=torch.float32))
        h.update(bf16_ulps(out, ref, layer_norm_terms(x, w, b, eps)), rows=x.numel() // x.shape[-1])
        h["ok"] = h["ok"] and h["max_ulps"] <= 1.0
        calls.append(h)
        return out

    return patched((LN, "layer_norm_one_pass", held))


def held_summary(calls: list) -> dict:
    """``hold`` results of one kernel's calls: calls, ok, the worst share of
    the limit and of the mean limit; for K6 also the most bf16 ulps, the
    least share bit-equal and the row counts seen."""
    out = dict(calls=len(calls), ok=all(x["ok"] for x in calls),
               worst_share_of_limit=max((x["worst_share_of_limit"] for x in calls), default=0.0),
               worst_mean_share=max((x["mean_share"] for x in calls), default=0.0))
    if calls and "max_ulps" in calls[0]:
        out.update(max_ulps=max(x["max_ulps"] for x in calls),
                   least_bit_equal_share=min(x["bit_equal_share"] for x in calls),
                   rows=sorted({x["rows"] for x in calls}))
    return out


def hold_lse(lse, ref) -> dict:
    """K2's log-sum-exp against the plain version's ``ref`` under
    LSE_REL_TOL: the worst share of the limit over the finite rows, and
    whether +inf marks exactly the same rows."""
    import torch

    lse, ref = lse.float(), ref.float()
    empty = torch.isinf(ref) & (ref > 0)
    same_empty = bool(torch.equal(torch.isposinf(lse), empty))
    err = (lse[~empty] - ref[~empty]).abs()
    share = (err / (LSE_REL_TOL * (1 + ref[~empty].abs()))).max().item() if err.numel() else 0.0
    return dict(max_abs_err=err.max().item() if err.numel() else 0.0, worst_share_of_limit=share,
                empty_rows=int(empty.sum().item()), same_empty_rows=same_empty,
                ok=same_empty and share <= 1.0)  # a NaN share fails


def backward_mags(q, k, v, lse, do, *, causal: bool, kv_mask=None, scale=None, o_mag=None):
    """The magnitudes the backward's bf16 roundings scale with, per output
    element, in fp32: dq -> scale |dS| |K|, dk -> scale |dS|^T |Q| and
    dv -> P^T |dO| (kv heads folded as in GQA). With them ``hold`` applies to
    the gradients: each side rounds P (for dV) or dS (for dK, dQ) to bf16 once,
    at most 2**-8 of each term, and rounds its result once (2**-8 |ref|), so
    kernel and plain version differ by at most 2**-7 (|ref| + mag).

    ``o_mag``: when the two sides start from different forward outputs (the
    kernel's o against the plain version's, each within ``hold``'s limit of
    the other, 2**-7 * o_mag with o_mag = |o| + mag_o + KERNEL_ABS_TOL /
    KERNEL_REL_TOL), delta = rowsum(dO * O) differs by at most
    2**-7 * rowsum(|dO| o_mag), so P * rowsum(|dO| o_mag) joins |dS|."""
    import torch

    import merv_tpu_torch.ops.attention as A

    B, H, Tq, D = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    kr, vr = A._repeat_kv(k, v, H)
    scale = D ** -0.5 if scale is None else scale
    qf, kf, vf, dof = q.float(), kr.float(), vr.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    vis = A._visible(B, Tq, Tk, causal, kv_mask, Tk - Tq, q.device)
    p = torch.where(vis, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
    del s
    o = A.flash_attention_forward_plain(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale).float()
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - (dof * o).sum(-1, keepdim=True))).abs()
    if o_mag is not None:
        ds = ds + p * (dof.abs() * o_mag.float()).sum(-1, keepdim=True)
    dq = torch.matmul(ds, kf.abs()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf.abs()) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof.abs())
    if Hk != H:
        dk = dk.view(B, Hk, H // Hk, Tk, D).sum(2)
        dv = dv.view(B, Hk, H // Hk, Tk, D).sum(2)
    return dq, dk, dv


@contextlib.contextmanager
def patched(*replacements):
    """Swap module attributes, given as (module, name, value), for the block."""
    saved = [(module, name, getattr(module, name)) for module, name, _ in replacements]
    for module, name, value in replacements:
        setattr(module, name, value)
    try:
        yield
    finally:
        for module, name, value in saved:
            setattr(module, name, value)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _randn(rng, shape, dev):
    import numpy as np
    import torch

    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)


def record_case(cases, kernel, name, shape, out, ref, mag, fn, plain, lib, bytes_moved, flops, extra=None,
                yardstick=None, device=False, graph=()):
    """Hold a kernel's output against its plain version (``hold``), time the
    kernel, the plain version, the PyTorch library call ``lib`` (None where no
    single call computes the function) and a composed ``yardstick`` (None if
    not given) with CUDA events, and append the row to ``cases``; raise if
    the output is not finite or outside the limit. ``device``: also the
    kernel's and the library call's device time (``device_ms``). ``graph``:
    which of "kernel", "library" and "yardstick" also get the graph-replay
    time (``graph_ms``: ``graph_ms``, ``library_graph_ms``,
    ``yardstick_graph_ms``)."""
    import torch

    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{kernel}/{name}: non-finite kernel output")
    h = hold(out, ref, mag)
    at = h["worst_at"]
    ms, plain_ms = time_ms(fn, 20), time_ms(plain, 5)
    lib_ms = time_ms(lib, 20) if lib is not None else None
    yard_ms = time_ms(yardstick, 20) if yardstick is not None else None
    bound_ms, bound_by = bound(bytes_moved, flops)
    row = dict(kernel=kernel, case=name, shape=shape, **h, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by, **(extra or {}))
    if yardstick is not None:
        row["yardstick_ms"] = yard_ms
    lib_text = "none" if lib_ms is None else f"{lib_ms:.4f}"
    yard_text = "" if yard_ms is None else f" yardstick_ms(composed)={yard_ms:.4f}"
    if device:
        row["device_ms"] = device_ms(fn)
        row["library_device_ms"] = device_ms(lib) if lib is not None else None
        yard_text += f" device_ms={row['device_ms']} library_device_ms={row['library_device_ms']}"
    for what, call, key in (("kernel", fn, "graph_ms"), ("library", lib, "library_graph_ms"),
                            ("yardstick", yardstick, "yardstick_graph_ms")):
        if what in graph:
            row[key] = graph_ms(call)
            yard_text += f" {key}={row[key]:.4f}"
    log(f"[kernel] {kernel:24s} {name:22s} {shape} max_err={h['max_abs_err']:.3e} "
        f"mean_err={h['mean_abs_err']:.3e} mean|ref|={h['mean_abs_ref']:.3e} mean_limit={h['mean_limit']:.3e} "
        f"worst/limit={h['worst_share_of_limit']:.3f} (err {at['err']:.3e} at ref {at['ref']:.3e}, "
        f"mag {at['mag']:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_text}{yard_text} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    if not h["ok"]:
        raise RuntimeError(f"{kernel}/{name}: outside |out - ref| <= {KERNEL_REL_TOL:.3g}*(|ref| + mag) + "
                           f"{KERNEL_ABS_TOL} or mean err <= {KERNEL_MEAN_SHARE} * mean limit")
    cases.append(row)


def kernel_cases(dev, seed: int, k1: bool = True, k2: bool = True, flash_cases=None):
    """K1 (unless ``k1`` is False) and K2 (unless ``k2`` is False; at
    ``flash_cases`` where given, else at the main paths' shapes) against
    their plain versions; K1 also with the graph-replay times of the kernel and
    of SDPA."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import merv_tpu_torch.ops.attention as A

    cases = []
    record = functools.partial(record_case, cases)

    rng = np.random.default_rng(seed)
    # K1: tower frame attention (DINOv2 T=261, LanguageBind spatial T=257)
    for name, T in (("dinov2_frames", 261), ("languagebind_spatial", 257)) if k1 else ():
        B, H, D = 16, 16, 64
        q, k, v = (_randn(rng, (B, H, T, D), dev) for _ in range(3))
        kt = k.transpose(-1, -2).contiguous()
        scale = D ** -0.5
        out = A.small_attention_kt(q, kt, v, scale)
        ref = A.small_attention_kt_plain(q, kt, v, scale)
        mag = A.small_attention_kt_plain(q, kt, v.abs(), scale)
        record(
            "small_attention_kt", name, [B, H, T, D], out, ref, mag,
            lambda: A.small_attention_kt(q, kt, v, scale),
            lambda: A.small_attention_kt_plain(q, kt, v, scale),
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            bytes_moved=4 * q.numel() * 2, flops=4.0 * B * H * T * T * D, device=True, graph=("kernel", "library"),
        )

    # K2: flash forward. (name, B, H, Hk, Tq, Tk, D, causal, q_offset, kv valid length per row / None)
    flash = [
        ("vivit_frames", 1, 12, 12, 3137, 3137, 64, False, None, None),
        # cache prefill: 1053 valid prompt tokens (BOS + 1024 visual + 28 text) padded to
        # 1088, against a 1120-slot cache whose last 32 slots are not written yet
        ("llama_cache_prefill", 1, 32, 32, 1088, 1120, 128, True, 0, "prefill"),
        # one row of the align micro-step's LLM forward (and its remat recompute): 64 of its 76 launches
        ("llama_training", 1, 32, 32, 3072, 3072, 128, True, None, None),
        ("gqa_causal", 1, 32, 8, 1088, 1088, 128, True, None, None),
        ("fully_masked_row", 2, 8, 8, 256, 512, 64, False, None, "row1_empty"),
        # the shared-prefix suffix prefill (generate_with_prefix): 8 questions' suffixes in a 64-token bucket
        # at q_offset P = 1025 (BOS + 1024 visual) in a cache of P + 64 + 64 new tokens; keys: the prefix and
        # each row's valid suffix tokens (ragged: SUFFIX_LENGTHS), not its pads nor the rows not written yet
        ("llama_suffix_prefill", 8, 32, 32, 64, 1153, 128, True, 1025, "suffix"),
    ]
    for name, B, H, Hk, Tq, Tk, D, causal, q_offset, mask_kind in (flash_cases or flash) if k2 else ():
        q = _randn(rng, (B, H, Tq, D), dev)
        k, v = (_randn(rng, (B, Hk, Tk, D), dev) for _ in range(2))
        mask = None
        if mask_kind == "prefill":
            mask = torch.zeros((B, Tk), dtype=torch.bool, device=dev)
            mask[:, :1053] = True
        elif mask_kind == "row1_empty":
            mask = torch.ones((B, Tk), dtype=torch.bool, device=dev)
            mask[1] = False
        elif mask_kind == "suffix":
            mask = torch.zeros((B, Tk), dtype=torch.bool, device=dev)
            mask[:, :q_offset] = True
            for b, n in enumerate(SUFFIX_LENGTHS):
                mask[b, q_offset : q_offset + n] = True
        kw = dict(causal=causal, kv_mask=mask, q_offset=q_offset)
        extra = {}
        out = A.flash_attention_forward(q, k, v, **kw)
        ref = A.flash_attention_forward_plain(q, k, v, **kw)
        mag = A.flash_attention_forward_plain(q, k, v.abs(), **kw)
        # the log-sum-exp, from a second launch that also writes o (which must not change)
        out_lse, lse = A.flash_attention_forward(q, k, v, return_lse=True, **kw)
        lse_ref = A.flash_attention_forward_plain(q, k, v, return_lse=True, **kw)[1]
        lse_h, planted = hold_lse(lse, lse_ref), hold_lse(lse + LSE_PLANTED_OFFSET, lse_ref)
        log(f"[kernel] flash_attention_forward {name:22s} lse: max_err={lse_h['max_abs_err']:.3e} "
            f"worst/limit={lse_h['worst_share_of_limit']:.4f} (|lse - ref| <= {LSE_REL_TOL:g}*(1 + |ref|)), "
            f"+inf rows {lse_h['empty_rows']} (same as plain: {lse_h['same_empty_rows']}); planted lse + "
            f"{LSE_PLANTED_OFFSET:g}: worst/limit {planted['worst_share_of_limit']:.2f} -> "
            f"{'not caught' if planted['ok'] else 'caught'}")
        if not torch.equal(out_lse, out):
            raise RuntimeError(f"flash_attention_forward/{name}: o changes when the lse is also written")
        if not lse_h["ok"]:
            raise RuntimeError(f"flash_attention_forward/{name}: lse outside its limit or +inf on other rows")
        if planted["ok"]:
            raise RuntimeError(f"flash_attention_forward/{name}: the lse check misses an offset of {LSE_PLANTED_OFFSET}")
        extra.update(lse=lse_h, lse_planted_offset_share=planted["worst_share_of_limit"])
        if mask_kind == "row1_empty":
            torch.cuda.synchronize()
            if out[1].abs().max().item() != 0.0:
                raise RuntimeError("flash_attention_forward: a row with no valid key must be exactly 0")
            if lse_h["empty_rows"] != H * Tq:
                raise RuntimeError(f"flash_attention_forward: {lse_h['empty_rows']} +inf lse rows, not {H * Tq}")
            extra["masked_row_exact_zero"] = True
        # valid (query, key) pairs this run's masks leave: the work the function needs
        valid = torch.ones((B, Tq, Tk), dtype=torch.bool, device=dev)
        if mask is not None:
            valid &= mask[:, None, :]
        if causal:
            off = Tk - Tq if q_offset is None else q_offset
            valid &= torch.arange(Tk, device=dev)[None, :] <= torch.arange(Tq, device=dev)[:, None] + off
        pairs = valid.sum().item() * H
        kr, vr = (k, v) if Hk == H else (k.repeat_interleave(H // Hk, 1), v.repeat_interleave(H // Hk, 1))
        # a plain causal square (no key mask, no offset) goes to SDPA as is_causal, which its flash backend takes
        sdpa_causal = causal and mask is None and q_offset is None and Tq == Tk
        sdpa_mask = valid[:, None] if (mask is not None or causal) and not sdpa_causal else None
        bytes_moved = (2 * q.numel() + k.numel() + v.numel()) * 2 + (0 if mask is None else mask.numel())
        record(
            "flash_attention_forward", name, [B, H, Hk, Tq, Tk, D], out, ref, mag,
            lambda: A.flash_attention_forward(q, k, v, **kw),
            lambda: A.flash_attention_forward_plain(q, k, v, **kw),
            lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=sdpa_mask, is_causal=sdpa_causal),
            bytes_moved=bytes_moved, flops=4.0 * pairs * D, extra=extra, device=True,
            graph=("kernel", "library") if mask_kind == "suffix" or flash_cases else (),
        )
        del valid
    return cases


def hold_from_plain_forward(q, k, v, lse, do, grads, **kw) -> dict:
    """What the backward kernel was given and gave, against the plain forward
    (the module's plain version as it stands): the forward kernel's ``lse``
    under ``hold_lse``, and the kernel's dq, dk, dv against the plain backward
    on the plain forward's o and lse, so that a fault of the kernel's o or lse
    cannot sit on both sides of the comparison."""
    import merv_tpu_torch.ops.attention as A

    o_p, lse_p = A.flash_attention_forward_plain(q, k, v, return_lse=True, **kw)
    o_mag = (o_p.float().abs() + A.flash_attention_forward_plain(q, k, v.abs(), **kw).float()
             + KERNEL_ABS_TOL / KERNEL_REL_TOL)
    return dict(lse=hold_lse(lse, lse_p), backward=hold_backward(q, k, v, o_p, lse_p, do, grads, o_mag=o_mag, **kw))


def visible_pairs(B, Tq, Tk, causal, mask, dev) -> int:
    """(query, key) pairs a head's function lets through, summed over the batch."""
    import torch

    valid = torch.ones((B, Tq, Tk), dtype=torch.bool, device=dev)
    if mask is not None:
        valid &= mask[:, None, :]
    if causal:
        valid &= torch.arange(Tk, device=dev)[None, :] <= torch.arange(Tq, device=dev)[:, None] + (Tk - Tq)
    return int(valid.sum().item())


def hold_backward(q, k, v, o, lse, do, grads, o_mag=None, **kw) -> dict:
    """dq, dk, dv of the kernel against the plain backward on q, k, v, do and
    the given o and lse (the module's plain version as it stands: a planted
    fault swaps it), each under ``hold`` with ``backward_mags``; the worst of
    the three."""
    import merv_tpu_torch.ops.attention as A

    refs = A.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    mags = backward_mags(q, k, v, lse, do, o_mag=o_mag, **kw)
    held = {name: hold(g, r, m) for name, g, r, m in zip(("dq", "dk", "dv"), grads, refs, mags)}
    worst = max(held.values(), key=lambda h: h["worst_share_of_limit"])
    return dict(worst, ok=all(h["ok"] for h in held.values()), per_grad=held,
                worst_mean_share=max(h["mean_abs_err"] / h["mean_limit"] for h in held.values()))


# (name, B, H, Hk, T, D, causal, mask kind): Tq == Tk, as in training
BACKWARD_CASES = [
    ("llama_training", 1, 32, 32, 3072, 128, True, None),
    ("gqa_causal", 1, 32, 8, 1088, 128, True, None),
    # ragged 1000 tokens; row 0 loses its last 100 keys, row 1 has no valid key at all
    ("ragged_fully_masked_row", 2, 8, 8, 1000, 128, True, "row1_empty"),
    ("vivit_d64", 1, 12, 12, 3137, 64, False, None),
]


def backward_cases(dev, seed: int):
    """The backward kernel against the plain backward, from the forward
    kernel's o and lse, with CUDA-event times of the kernel, the plain
    version and SDPA forward + backward (a yardstick only)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import merv_tpu_torch.ops.attention as A

    rng = np.random.default_rng(seed + 7)
    cases = []
    for name, B, H, Hk, T, D, causal, mask_kind in BACKWARD_CASES:
        q = _randn(rng, (B, H, T, D), dev)
        k, v = (_randn(rng, (B, Hk, T, D), dev) for _ in range(2))
        do = _randn(rng, (B, H, T, D), dev)
        mask = None
        if mask_kind == "row1_empty":
            mask = torch.ones((B, T), dtype=torch.bool, device=dev)
            mask[0, T - 100:] = False
            mask[1] = False
        kw = dict(causal=causal, kv_mask=mask)
        o, lse = A.flash_attention_forward(q, k, v, return_lse=True, **kw)
        grads = A.flash_attention_backward(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        if not all(torch.isfinite(g.float()).all() for g in grads):
            raise RuntimeError(f"flash_attention_backward/{name}: non-finite gradient")
        h = hold_backward(q, k, v, o, lse, do, grads, **kw)
        fp = hold_from_plain_forward(q, k, v, lse, do, grads, **kw)
        extra = dict(lse=fp["lse"], from_plain_forward={g: {x: y for x, y in r.items() if x != "worst_at"}
                                                        for g, r in fp["backward"]["per_grad"].items()})
        if mask_kind == "row1_empty":
            if any(g[1].abs().max().item() != 0.0 for g in grads):
                raise RuntimeError("flash_attention_backward: a row with no valid key must have zero gradient")
            if fp["lse"]["empty_rows"] != H * T:
                raise RuntimeError(f"flash_attention_forward: {fp['lse']['empty_rows']} +inf lse rows, not {H * T}")
            extra["masked_row_exact_zero"] = True

        kr, vr = (k, v) if Hk == H else (k.repeat_interleave(H // Hk, 1), v.repeat_interleave(H // Hk, 1))
        leaves = [x.detach().clone().requires_grad_() for x in (q, kr, vr)]
        sdpa_mask = None
        if mask is not None:
            sdpa_mask = mask[:, None, None, :] & (torch.ones((T, T), dtype=torch.bool, device=dev).tril()
                                                  if causal else True)

        def library():
            for x in leaves:
                x.grad = None
            out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask, is_causal=causal and mask is None)
            out.backward(do)

        # deterministic: no atomics, so a second call on the same inputs gives the same bits
        again = A.flash_attention_backward(q, k, v, o, lse, do, **kw)
        extra["deterministic"] = all(torch.equal(a, b) for a, b in zip(grads, again))
        del again
        if not extra["deterministic"]:
            raise RuntimeError(f"flash_attention_backward/{name}: two calls on the same inputs differ")

        kernel = lambda: A.flash_attention_backward(q, k, v, o, lse, do, **kw)  # noqa: E731
        ms = time_ms(kernel, 10)
        plain_ms = time_ms(lambda: A.flash_attention_backward_plain(q, k, v, o, lse, do, **kw), 3)
        lib_ms = time_ms(library, 10)
        extra["device_ms"], extra["library_device_ms"] = device_ms(kernel), device_ms(library)
        pairs = visible_pairs(B, T, T, causal, mask, dev) * H
        # read q, k, v, o, dO (bf16), lse (fp32) and the mask once; write dq, dk, dv
        bytes_moved = ((4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * 2 + lse.numel() * 4
                       + (0 if mask is None else mask.numel()))
        bound_ms, bound_by = bound(bytes_moved, 10.0 * D * pairs)
        row = dict(kernel="flash_attention_backward", case=name, shape=[B, H, Hk, T, T, D], **h, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, **extra)
        per = "; ".join(f"{g} worst/limit {x['worst_share_of_limit']:.3f} max_err {x['max_abs_err']:.3e} "
                        f"mean_err/mean_limit {x['mean_abs_err'] / x['mean_limit']:.4f}"
                        for g, x in h["per_grad"].items())
        per_plain = "; ".join(f"{g} worst/limit {x['worst_share_of_limit']:.3f} mean_err/mean_limit "
                              f"{x['mean_abs_err'] / x['mean_limit']:.4f}" for g, x in fp["backward"]["per_grad"].items())
        log(f"[kernel] flash_attention_backward {name:24s} {row['shape']} {per}; ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms(SDPA fwd+bwd)={lib_ms:.4f} device_ms={extra['device_ms']} "
            f"library_device_ms={extra['library_device_ms']} bound_ms={bound_ms:.4f} ({bound_by}); "
            f"two calls bit-identical: {extra['deterministic']}")
        log(f"[kernel] flash_attention_backward {name:24s} against the plain backward on the plain forward's o and "
            f"lse: {per_plain}; forward kernel's lse worst/limit {fp['lse']['worst_share_of_limit']:.4f}, +inf rows "
            f"{fp['lse']['empty_rows']} (same as plain: {fp['lse']['same_empty_rows']})")
        if not h["ok"]:
            raise RuntimeError(f"flash_attention_backward/{name}: a gradient is outside its limit against the plain "
                               f"backward")
        if not fp["lse"]["ok"] or not fp["backward"]["ok"]:
            raise RuntimeError(f"flash_attention_backward/{name}: the lse, or a gradient against the plain backward "
                               f"on the plain forward's o and lse, is outside its limit")
        cases.append(row)
        del grads, leaves, o, lse
    return cases


# ---------------------------------------------------------------------------
# phase 3, continued: the towers' three opt-in kernels (B3, B5, B6)
# ---------------------------------------------------------------------------


def fused_block_mags(x, ns, nb, wq, bq, wk, bk, wv, bv, wo, bo, gamma, heads, eps):
    """The magnitude B6's bf16 roundings scale with, per output element, in
    fp32: |gamma| * ((|o| + 2 (p/l)|v|) @ |Wo|^T). Each side rounds p / l to
    bf16 (at most 2**-8 of each term of o_j = sum (p/l) v_j), may round a v on
    the other side of a bf16 boundary (2**-8 of each term again) and rounds
    o_j itself (2**-8 |o_j|), so the two sides' o_j differ by at most
    2**-7 (|o_j| + 2 (p/l)|v_j|); the o-projection carries that through
    |gamma_n| |Wo[n, j]| summed over j. Each side rounds its output once
    (2**-8 |ref|), so ``hold``'s 2**-7 (|ref| + mag) covers both. fp32
    summation order is the absolute term's.

    The bound is sound but loose (it adds |Wo| over the hidden width), and x
    passes through the output, so a fault inside the attention shows in the
    output only when it is large: ``hold_fused`` holds each stage on its own
    besides."""
    import torch

    import merv_tpu_torch.ops.fused_vit_block as TF

    B, S, D = x.shape
    _, xn = TF._layer_norm(x, ns, nb, eps)
    xn = xn.float()

    def proj(w, b):
        return TF._heads((torch.matmul(xn, w.float().t()) + b.float()).to(x.dtype), heads).float()

    q, k, v = proj(wq, bq), proj(wk, bk), proj(wv, bv)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * (D // heads) ** -0.5, dim=-1)
    m = torch.matmul(p, v).abs() + 2 * torch.matmul(p, v.abs())
    del p, q, k
    return gamma.float().abs() * torch.matmul(m.transpose(1, 2).reshape(B, S, D), wo.float().abs().t())


def hold_fused(args, out, stages) -> dict:
    """B6 held end to end and stage by stage, each stage against the plain
    version's on the kernel's own inputs to it (``stages`` from
    ``fused_vit_attn_block_stages``), at either head dim (the scale
    1 / sqrt(D / heads) throughout):

    - output: ``hold`` against the plain version, mag ``fused_block_mags``;
    - ln_stats: mean and 1/sqrt(var + eps) per row within STATS_REL_TOL;
    - qkv: the plain projections of LN1's output rebuilt from the kernel's
      statistics (the same fp32 operations, so the same bf16 xn): the two
      sides differ only in fp32 summation order before one rounding, at most
      one bf16 ulp (<= 2**-7 |ref|), so mag = |ref|;
    - attention: the plain attention on the kernel's q, k, v, mag the same on
      |v| (as for B3);
    - o_projection: the plain epilogue on the kernel's attention output and
      x, one rounding again, so mag = |ref|.

    ok only if every hold is."""
    import merv_tpu_torch.ops.fused_vit_block as TF

    x, ns, nb, wq, bq, wk, bk, wv, bv, wo, bo, gamma, heads, eps = args
    D = x.shape[-1]
    xf = x.float()
    r = {"output": hold(out, TF.fused_vit_attn_block_plain(*args), fused_block_mags(*args))}
    mu, rstd = TF._ln_stats(xf, eps)
    share = max(((stages["mu"] - mu).abs() / (STATS_REL_TOL * (mu.abs() + 1 / rstd))).max().item(),
                ((stages["rstd"] - rstd).abs() / (STATS_REL_TOL * rstd)).max().item())
    r["ln_stats"] = dict(worst_share_of_limit=share, mean_share=0.0, ok=share <= 1.0)
    xn = TF._normalize(xf, stages["mu"], stages["rstd"], ns, nb, x.dtype)
    for name, got, ref in zip(("q", "k", "v"), (stages["q"], stages["k"], stages["v"]),
                              TF._plain_qkv(xn, wq, bq, wk, bk, wv, bv, heads)):
        r[name] = hold(got, ref, ref.float().abs())
    del xn
    q, k, v, scale = stages["q"], stages["k"], stages["v"], (D // heads) ** -0.5
    r["attention"] = hold(stages["o"], TF._plain_attention(q, k, v, scale), TF._plain_attention(q, k, v.abs(), scale))
    ref = TF._plain_out(xf, stages["o"], wo, bo, gamma, x.dtype)
    r["o_projection"] = hold(out, ref, ref.float().abs())
    return dict(ok=all(h["ok"] for h in r.values()),
                worst_share_of_limit=max(h["worst_share_of_limit"] for h in r.values()),
                mean_share=max(h["mean_share"] for h in r.values()),
                stages={k: dict(worst_share_of_limit=h["worst_share_of_limit"], mean_share=h["mean_share"], ok=h["ok"])
                        for k, h in r.items()})


def stage_text(h: dict) -> str:
    return ", ".join(f"{k} {v['worst_share_of_limit']:.3f}" for k, v in h["stages"].items())


def planted_tower_faults():
    """Faulty stand-ins for the plain versions of K1 and B3 at head dim 72, B3,
    B5 and B6, as (module, name, function): faults the call-by-call checks must
    catch."""
    import torch

    import merv_tpu_torch.ops.attention as A
    import merv_tpu_torch.ops.fused_vit_block as TF

    small_kt_plain = A.small_attention_kt_plain
    plain_qkv, plain_attention, plain_out = TF._plain_qkv, TF._plain_attention, TF._plain_out

    def b3_kv_head_ignored(q, k, v, scale):
        # query head h reads kv head h % Hk (heads tiled), not h // (H / Hk) (grouped)
        rep = q.shape[1] // k.shape[1]
        return small_kt_plain(q, k.repeat(1, rep, 1, 1).transpose(-1, -2), v.repeat(1, rep, 1, 1), scale)

    def head_dim_tail_ignored_kt(q, kt, v, scale):
        q64 = q.clone()
        q64[..., 64:] = 0
        out = small_kt_plain(q64, kt, v, scale)
        out[..., 64:] = 0
        return out

    def head_dim_tail_ignored(q, k, v, scale):
        rep = q.shape[1] // k.shape[1]
        return head_dim_tail_ignored_kt(q, k.repeat_interleave(rep, 1).transpose(-1, -2), v.repeat_interleave(rep, 1),
                                        scale)

    def b5_mask_dropped(q, kt, v, scale, heads):
        # every packed row attends every row, of every head
        return small_kt_plain(q[:, None], kt[:, None], v[:, None], scale)[:, 0]

    # B6's faults replace one stage of the plain version, which its end-to-end
    # plain function and the stage-by-stage hold (``hold_fused``) both call
    def b6_gamma_ignored(xf, o, wo, bo, gamma, dtype):
        return plain_out(xf, o, wo, bo, torch.ones_like(gamma), dtype)  # LayerScale gamma taken as 1

    def b6_scores_unscaled(q, k, v, scale):
        return plain_attention(q, k, v, 0.0)  # scale 0: every key weighted alike

    def b6_scale_of_head_dim_64(q, k, v, scale):
        return plain_attention(q, k, v, 64 ** -0.5)  # the softmax scale of head dim 64 at any head dim

    def b6_q_bias_dropped(xn, wq, bq, wk, bk, wv, bv, heads):
        return plain_qkv(xn, wq, torch.zeros_like(bq), wk, bk, wv, bv, heads)

    return {
        "b3_kv_head_ignored": (A, "small_attention_plain", b3_kv_head_ignored),
        # a kernel that still reads 64-column slabs at head dim 72: scores over columns 0-63, columns 64-71 left 0
        "k1_head_dim_tail_ignored": (A, "small_attention_kt_plain", head_dim_tail_ignored_kt),
        "b3_head_dim_tail_ignored": (A, "small_attention_plain", head_dim_tail_ignored),
        "b5_mask_dropped": (A, "packed_temporal_attention_plain", b5_mask_dropped),
        "b6_gamma_ignored": (TF, "_plain_out", b6_gamma_ignored),
        "b6_scores_unscaled": (TF, "_plain_attention", b6_scores_unscaled),
        "b6_scale_of_head_dim_64": (TF, "_plain_attention", b6_scale_of_head_dim_64),
        "b6_q_bias_dropped": (TF, "_plain_qkv", b6_q_bias_dropped),
    }


def fused_layer(dev, cfg, seed: int):
    """A ViTLayer of a tower's config on the card (bf16, random init from a
    seeded generator, LN affine perturbed so that it shows; LayerScale gamma
    drawn in [0.05, 0.15])."""
    import dataclasses

    import torch

    from merv_tpu_torch.device import make_generator
    from merv_tpu_torch.models.backbones.video.vit import ViTLayer
    from merv_tpu_torch.nn.core import init_weights

    cfg = dataclasses.replace(cfg, temporal_attn=False, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    layer = ViTLayer(cfg, device=dev)
    g = make_generator(dev, seed)
    init_weights(layer, g)
    D = cfg.hidden_size
    with torch.no_grad():
        layer.norm1.weight.copy_(1 + 0.1 * torch.randn(D, generator=g, device=dev))
        layer.norm1.bias.copy_(0.1 * torch.randn(D, generator=g, device=dev))
        if cfg.use_layerscale:
            layer.ls1.gamma.uniform_(0.05, 0.15, generator=g)
    return layer


def fused_args(layer, x):
    """The arguments ViTLayer.forward gives fused_vit_attn_block."""
    import torch

    c, ap = layer.cfg, layer.attn
    gamma = layer.ls1.gamma if c.use_layerscale else torch.ones(c.hidden_size, dtype=c.param_dtype, device=x.device)
    return (x, layer.norm1.weight, layer.norm1.bias, ap.q_proj.weight, ap.q_proj.bias, ap.k_proj.weight,
            ap.k_proj.bias, ap.v_proj.weight, ap.v_proj.bias, ap.o_proj.weight, ap.o_proj.bias, gamma, c.num_heads,
            c.layer_norm_eps)


# (name, B, H, Hk, T): B3 on the towers' frames (the MERV_TPU_TOWER_ATTN=xla route), a ragged T, and GQA
B3_CASES = (("dinov2_frames", 16, 16, 16, 261), ("languagebind_spatial", 16, 16, 16, 257),
            ("ragged_t229", 16, 16, 16, 229), ("gqa_16_to_4", 4, 16, 4, 261))
# (Bn, R, D, heads): B5 on LanguageBind's packed windows (2 windows x 257 tokens; 8 frames x 16 heads)
B5_CASE = (514, 128, 64, 16)
# (tower, B, S): B6 on each tower's attention half-layer at merv-base's batch shapes, and DINOv2's at phase 5b's
B6_CASES = (("dinov2", 16, 261), ("languagebind", 16, 257), ("siglip", 16, 196), ("vivit", 1, 3137),
            ("dinov2_b256", 256, 261))  # phase 5b's align micro-batch: 16 videos x 16 frames


def tower_kernel_cases(dev, seed: int, b3_only: bool = False, by_launch: bool = False):
    """B3, B5 and B6 (only B3 if ``b3_only``) against their plain versions at
    merv-base's shapes, with the kernel, plain, library (SDPA for B3 and B5)
    and composed-yardstick times (B6: the default route's attention
    half-layer, norm1 -> _mha -> LayerScale -> residual) beside the bounds,
    and graph-replay times of B3, B5 and their SDPA, and of B6 and its
    composed half-layer; each planted fault of ``planted_tower_faults`` must
    fail the same hold. ``by_launch``: B6's device time by launch too."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import merv_tpu_torch.ops.attention as A
    import merv_tpu_torch.ops.fused_vit_block as TF
    from merv_tpu_torch.models.backbones.video.vit import (
        DINOV2_LARGE_REG4,
        LANGUAGEBIND_VIDEO_LARGE,
        SIGLIP_BASE_224,
        VIVIT_BASE_16x2,
    )

    cases, faults = [], planted_tower_faults()
    record = functools.partial(record_case, cases)
    rng = np.random.default_rng(seed + 11)

    def fault_caught(kernel, name, fault, out, args, mag):
        h = hold(out, faults[fault][2](*args), mag)
        log(f"[fault] {fault:24s} {kernel}/{name}: worst/limit {h['worst_share_of_limit']:.2f}, mean err/mean limit "
            f"{h['mean_abs_err'] / h['mean_limit']:.3f} -> {'not caught' if h['ok'] else 'caught'}")
        if h["ok"]:
            raise RuntimeError(f"planted fault {fault} was not caught on {kernel}/{name}")
        return h["worst_share_of_limit"]

    for name, B, H, Hk, T in B3_CASES:
        D, scale = 64, 64 ** -0.5
        q = _randn(rng, (B, H, T, D), dev)
        k, v = (_randn(rng, (B, Hk, T, D), dev) for _ in range(2))
        out = A.small_attention(q, k, v, scale)
        mag = A.small_attention_plain(q, k, v.abs(), scale)
        extra = {}
        if Hk != H:
            extra["fault_b3_kv_head_ignored_share"] = fault_caught("small_attention", name, "b3_kv_head_ignored",
                                                                   out, (q, k, v, scale), mag)
        record(
            "small_attention", name, [B, H, Hk, T, D], out, A.small_attention_plain(q, k, v, scale), mag,
            lambda: A.small_attention(q, k, v, scale), lambda: A.small_attention_plain(q, k, v, scale),
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale, enable_gqa=Hk != H),
            bytes_moved=(2 * q.numel() + 2 * k.numel()) * 2, flops=4.0 * B * H * T * T * D, extra=extra,
            device=True, graph=("kernel", "library"),
        )
    if b3_only:
        return cases

    Bn, R, D, heads = B5_CASE
    scale = D ** -0.5
    q, v = (_randn(rng, (Bn, R, D), dev) for _ in range(2))
    kt = _randn(rng, (Bn, D, R), dev)
    out = A.packed_temporal_attention(q, kt, v, scale, heads)
    mag = A.packed_temporal_attention_plain(q, kt, v.abs(), scale, heads)
    share = fault_caught("packed_temporal_attention", "languagebind_temporal", "b5_mask_dropped", out,
                         (q, kt, v, scale, heads), mag)
    same_head = A._same_head(R, heads, dev)
    # the library call on k as a user's projection gives it: [Bn, 1, R, D], contiguous
    k_rows = kt.transpose(-1, -2).contiguous()[:, None]

    def sdpa_masked(k=k_rows):
        return F.scaled_dot_product_attention(q[:, None], k, v[:, None], attn_mask=same_head, scale=scale)

    probe = sdpa_probe(sdpa_masked)
    probe["strided_k_ms"] = time_ms(lambda: sdpa_masked(kt.transpose(-1, -2)[:, None]), 20)
    log(f"[sdpa] packed_temporal_attention yardstick: default backend kernels {probe['default_kernels']}; "
        f"forced {probe['backends_ms']}; with k strided (last-dim stride {R}) {probe['strided_k_ms']:.4f} ms")
    record(
        "packed_temporal_attention", "languagebind_temporal", [Bn, R, D, heads], out,
        A.packed_temporal_attention_plain(q, kt, v, scale, heads), mag,
        lambda: A.packed_temporal_attention(q, kt, v, scale, heads),
        lambda: A.packed_temporal_attention_plain(q, kt, v, scale, heads), sdpa_masked,
        # the function needs each row's R / heads same-head keys
        bytes_moved=4 * q.numel() * 2, flops=4.0 * Bn * R * (R // heads) * D,
        extra=dict(fault_b5_mask_dropped_share=share, library=probe), graph=("kernel", "library"),
    )

    towers = dict(dinov2=DINOV2_LARGE_REG4, languagebind=LANGUAGEBIND_VIDEO_LARGE, siglip=SIGLIP_BASE_224,
                  vivit=VIVIT_BASE_16x2)
    for name, B, S in B6_CASES:
        cfg = towers[name.split("_")[0]]
        layer = fused_layer(dev, cfg, seed + S)
        D = cfg.hidden_size
        x = _randn(rng, (B, S, D), dev)
        args = fused_args(layer, x)
        out, stages = TF.fused_vit_attn_block_stages(*args)
        held = hold_fused(args, out, stages)
        log(f"[kernel] fused_vit_attn_block     {name:22s} by stage, worst/limit: {stage_text(held)}")
        # the output's bits, to compare two trees' kernels on the same inputs (chip_ab.sh --tower-only)
        digest = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
        log(f"[digest] fused_vit_attn_block {name} {list(out.shape)} sha256 {digest}")
        if not held["ok"]:
            raise RuntimeError(f"fused_vit_attn_block/{name}: a stage is outside its limit: {held['stages']}")
        extra = dict(stages=held["stages"], sha256=digest)
        b6_faults = ("b6_q_bias_dropped", "b6_scores_unscaled") + (("b6_gamma_ignored",) if cfg.use_layerscale else ())
        for fault in b6_faults:
            with patched(faults[fault]):
                h = hold_fused(args, out, stages)
            log(f"[fault] {fault:24s} fused_vit_attn_block/{name}: worst/limit {h['worst_share_of_limit']:.2f} "
                f"({stage_text(h)}) -> {'not caught' if h['ok'] else 'caught'}")
            if h["ok"]:
                raise RuntimeError(f"planted fault {fault} was not caught on fused_vit_attn_block/{name}")
            extra[f"fault_{fault}"] = h["stages"]
        del stages
        if S <= 512:  # both attention stages take the shape: each forced, held and timed
            for stage, key_tiled in (("whole_head", False), ("key_tiled", True)):
                out_t, stages_t = TF.fused_vit_attn_block_stages(*args, key_tiled=key_tiled)
                held_t = hold_fused(args, out_t, stages_t)
                log(f"[kernel] fused_vit_attn_block     {name:22s} {stage} stage forced, by stage, worst/limit: "
                    f"{stage_text(held_t)}")
                if not held_t["ok"]:
                    raise RuntimeError(f"fused_vit_attn_block/{name} {stage}: a stage is outside its limit")
                extra[f"{stage}_stages"] = held_t["stages"]
                del out_t, stages_t
            ms = {"whole_head": [], "key_tiled": []}
            for _ in range(3):  # graph replay, interleaved: whole, tiled, whole, tiled, ...
                for stage, key_tiled in (("whole_head", False), ("key_tiled", True)):
                    ms[stage].append(graph_ms(lambda: TF.fused_vit_attn_block_stages(*args, key_tiled=key_tiled)))
            log(f"[kernel] fused_vit_attn_block     {name:22s} graph ms, whole-head stage {ms['whole_head']}, "
                f"key-tiled stage {ms['key_tiled']}")
            extra["attention_stage_ms"] = ms

        if by_launch:
            extra["kernel_device_ms"] = kernel_device_ms(lambda: TF.fused_vit_attn_block(*args))
            log(f"[kernel] fused_vit_attn_block     {name:22s} device ms by kernel: "
                + ", ".join(f"{k} {v:.4f}" for k, v in extra["kernel_device_ms"].items())
                + f" (sum {sum(extra['kernel_device_ms'].values()):.4f})")

        def composed(layer=layer, x=x):  # the default route's attention half-layer
            with torch.no_grad():
                h = layer._mha(layer.attn, layer.norm1(x), "auto")
                return x + (layer.ls1(h) if layer.cfg.use_layerscale else h)

        record(
            "fused_vit_attn_block", name, [B, S, D, cfg.num_heads], out, TF.fused_vit_attn_block_plain(*args),
            fused_block_mags(*args), lambda: TF.fused_vit_attn_block(*args),
            lambda: TF.fused_vit_attn_block_plain(*args), None,
            bytes_moved=2 * x.numel() * 2 + 4 * D * D * 2 + 7 * D * 4,
            flops=2.0 * B * S * D * 4 * D + 4.0 * B * S * S * D, extra=extra, yardstick=composed,
            graph=("kernel", "yardstick"),
        )
        del layer
    return cases


# K1 and B3 at SigLIP so400m's head dim 72: (name, B, H, Hk, T); so400m's 16 frames of 256 tokens (16 heads),
# a ragged T, the longest T the kernels take, and a GQA case for B3's kv-head fault
D72_CASES = (("so400m_frames", 16, 16, 16, 256), ("ragged_t229", 16, 16, 16, 229), ("t512", 16, 16, 16, 512),
             ("gqa_16_to_4", 4, 16, 4, 256))


def head_dim_72_cases(dev, seed: int):
    """K1 (small_attention_kt) and B3 (small_attention) at head dim 72, each
    held element by element against its plain version, timed by CUDA events,
    graph replay and the profiler beside SDPA on the same shape and the byte
    bound (q, k, v, o read or written once); the planted faults that a kernel
    still reading 64-column slabs would make (columns 64-71 ignored) and B3's
    kv-head fault (on the GQA case) must fail the same hold."""
    import numpy as np
    import torch.nn.functional as F

    import merv_tpu_torch.ops.attention as A

    cases, faults = [], planted_tower_faults()
    record = functools.partial(record_case, cases)
    rng = np.random.default_rng(seed + 72)

    def caught(kernel, name, fault, out, args, mag):
        h = hold(out, faults[fault][2](*args), mag)
        log(f"[fault] {fault:24s} {kernel}/{name}: worst/limit {h['worst_share_of_limit']:.2f} -> "
            f"{'not caught' if h['ok'] else 'caught'}")
        if h["ok"]:
            raise RuntimeError(f"planted fault {fault} was not caught on {kernel}/{name}")
        return h["worst_share_of_limit"]

    for name, B, H, Hk, T in D72_CASES:
        D = 72
        scale = D ** -0.5
        q = _randn(rng, (B, H, T, D), dev)
        k, v = (_randn(rng, (B, Hk, T, D), dev) for _ in range(2))
        bytes_moved = (2 * q.numel() + 2 * k.numel()) * 2
        flops = 4.0 * B * H * T * T * D
        if Hk == H:
            kt = k.transpose(-1, -2).contiguous()
            out = A.small_attention_kt(q, kt, v, scale)
            mag = A.small_attention_kt_plain(q, kt, v.abs(), scale)
            extra = dict(fault_k1_head_dim_tail_ignored_share=caught(
                "small_attention_kt", name, "k1_head_dim_tail_ignored", out, (q, kt, v, scale), mag))
            record(
                "small_attention_kt", f"d72_{name}", [B, H, T, D], out, A.small_attention_kt_plain(q, kt, v, scale),
                mag, lambda: A.small_attention_kt(q, kt, v, scale), lambda: A.small_attention_kt_plain(q, kt, v, scale),
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), bytes_moved=bytes_moved, flops=flops,
                extra=extra, device=True, graph=("kernel", "library"),
            )
        out = A.small_attention(q, k, v, scale)
        mag = A.small_attention_plain(q, k, v.abs(), scale)
        extra = dict(fault_b3_head_dim_tail_ignored_share=caught(
            "small_attention", name, "b3_head_dim_tail_ignored", out, (q, k, v, scale), mag))
        if Hk != H:
            extra["fault_b3_kv_head_ignored_share"] = caught("small_attention", name, "b3_kv_head_ignored", out,
                                                             (q, k, v, scale), mag)
        record(
            "small_attention", f"d72_{name}", [B, H, Hk, T, D], out, A.small_attention_plain(q, k, v, scale), mag,
            lambda: A.small_attention(q, k, v, scale), lambda: A.small_attention_plain(q, k, v, scale),
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale, enable_gqa=Hk != H),
            bytes_moved=bytes_moved, flops=flops, extra=extra, device=True, graph=("kernel", "library"),
        )
    return cases


# B6 at SigLIP so400m's head dim 72 (hidden 1152, 16 heads): (name, B, S). so400m's 16 frames of 256 tokens, a
# ragged S, the lengths that cross B6's stage boundaries at head dim 64 (257: the whole-head stage's first;
# 513: past its last; at 72 the key-tiled stage takes all of them), and phase 5b's align micro-batch (16 videos x
# 16 frames)
B6_D72_CASES = (("so400m_frames", 16, 256), ("ragged_s229", 16, 229), ("s257", 16, 257), ("s513", 8, 513),
                ("so400m_b256", 256, 256))
B6_D72_FAULTS = ("b6_q_bias_dropped", "b6_scores_unscaled", "b6_scale_of_head_dim_64")


def fused_d72_cases(dev, seed: int) -> list:
    """B6 (fused_vit_attn_block) at head dim 72 on so400m's layers (random
    init from a seeded generator): held end to end and stage by stage
    (``hold_fused``), its launch counted under its own counter, the planted
    faults of ``B6_D72_FAULTS`` (the scale of head dim 64 among them) caught;
    timed by CUDA events and graph replay beside the default route's composed
    half-layer; on so400m's shape also its device time by launch."""
    import numpy as np
    import torch

    import merv_tpu_torch.ops.attention as A
    import merv_tpu_torch.ops.fused_vit_block as TF
    from merv_tpu_torch.models.backbones.video.vit import SIGLIP_SO400M_224 as cfg

    cases, faults = [], planted_tower_faults()
    record = functools.partial(record_case, cases)
    rng = np.random.default_rng(seed + 1152)
    D, H = cfg.hidden_size, cfg.num_heads
    for name, B, S in B6_D72_CASES:
        layer = fused_layer(dev, cfg, seed + 72 + S)
        x = _randn(rng, (B, S, D), dev)
        args = fused_args(layer, x)
        before = A.launch_counts()
        out, stages = TF.fused_vit_attn_block_stages(*args)
        torch.cuda.synchronize()
        if A.launches_since(before) != {"fused_vit_attn_block_d72": 1}:
            raise RuntimeError(f"fused_vit_attn_block_d72/{name}: one call counted {A.launches_since(before)}")
        held = hold_fused(args, out, stages)
        log(f"[kernel] fused_vit_attn_block_d72 {name:22s} by stage, worst/limit: {stage_text(held)}")
        if not held["ok"]:
            raise RuntimeError(f"fused_vit_attn_block_d72/{name}: a stage is outside its limit: {held['stages']}")
        extra = dict(stages=held["stages"])
        for fault in B6_D72_FAULTS:
            with patched(faults[fault]):
                h = hold_fused(args, out, stages)
            log(f"[fault] {fault:24s} fused_vit_attn_block_d72/{name}: worst/limit {h['worst_share_of_limit']:.2f}, "
                f"mean err/mean limit {h['mean_share']:.3f} -> {'not caught' if h['ok'] else 'caught'}")
            if h["ok"]:
                raise RuntimeError(f"planted fault {fault} was not caught on fused_vit_attn_block_d72/{name}")
            extra[f"fault_{fault}"] = h["stages"]
        del stages
        if name == "so400m_frames":
            extra["kernel_device_ms"] = kernel_device_ms(lambda: TF.fused_vit_attn_block(*args))
            log(f"[kernel] fused_vit_attn_block_d72 {name:22s} device ms by kernel: "
                + ", ".join(f"{k} {v:.4f}" for k, v in extra["kernel_device_ms"].items())
                + f" (sum {sum(extra['kernel_device_ms'].values()):.4f})")

        def composed(layer=layer, x=x):  # the default route's attention half-layer (K1 at head dim 72 at 224-512)
            with torch.no_grad():
                h = layer._mha(layer.attn, layer.norm1(x), "auto")
                return x + (layer.ls1(h) if layer.cfg.use_layerscale else h)

        record(
            "fused_vit_attn_block_d72", name, [B, S, D, H], out, TF.fused_vit_attn_block_plain(*args),
            fused_block_mags(*args), lambda: TF.fused_vit_attn_block(*args),
            lambda: TF.fused_vit_attn_block_plain(*args), None,
            bytes_moved=2 * x.numel() * 2 + 4 * D * D * 2 + 7 * D * 4,
            flops=2.0 * B * S * D * 4 * D + 4.0 * B * S * S * D, extra=extra, yardstick=composed,
            graph=("kernel", "yardstick"),
        )
        del layer, out
    return cases


def sdpa_probe(call) -> dict:
    """Which SDPA backend ``call`` runs by default (the device kernels of one
    call, from ``torch.profiler``; "not measured" if the trace holds none)
    and each backend's time where it takes these inputs."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e.key[:80] for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    backends = {}
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                backends[b.name] = time_ms(call, 20)
        except RuntimeError:  # the backend does not take these inputs
            backends[b.name] = "refused"
    return dict(default_kernels=kernels or "not measured", backends_ms=backends)


# ---------------------------------------------------------------------------
# phase 3, continued: K4 (int8_linear) and K5 (decode_attention)
# ---------------------------------------------------------------------------

# K4 at Llama-2-7B's weight shapes (N, K) and the row counts of x the paths give it: 1 (generate), 4 (the
# engine's 4 slots), 8 (eval at batch 8), 36 (the engine's verify at gamma 8); and an N that is not a
# multiple of the kernel's 16 output columns
INT8_WEIGHTS = (("qkvo", 4096, 4096), ("gate_up", 11008, 4096), ("down", 4096, 11008), ("lm_head", 32064, 4096))
INT8_ROWS = (1, 4, 8, 36)
INT8_RAGGED = ("ragged_n", 5, 4100, 4096)
# K5: (name, B, H, Hk, Tq, Tk, D, int8, valid rows per batch row, causal offsets [B] or None).
# B = 1 at phase 4's decode shape (a 1,120-row cache, 1,100 rows written); the engine's 4 slots over a
# 2,058-row cache (the last the scratch row) with ragged lengths; its verify at Tq = 5 and 9 with [B]
# offsets; GQA 32 -> 8; D = 64
# L2-cold timing: the decode step reads each layer's weights and cache once, never from L2, so K4, K5 and
# their yardsticks are also timed over calls that rotate through distinct copies of their inputs, together
# more than the H100's 50 MB L2
COLD_BYTES = 64 << 20
ENGINE_LENGTHS = (2040, 1100, 317, 1)
DECODE_CASES = (
    ("b1_bf16", 1, 32, 32, 1, 1120, 128, False, (1100,), None),
    ("b1_int8", 1, 32, 32, 1, 1120, 128, True, (1100,), None),
    ("engine_bf16", 4, 32, 32, 1, 2058, 128, False, ENGINE_LENGTHS, None),
    ("engine_int8", 4, 32, 32, 1, 2058, 128, True, ENGINE_LENGTHS, None),
    ("verify5_bf16", 4, 32, 32, 5, 2058, 128, False, ENGINE_LENGTHS, "lengths"),
    ("verify5_int8", 4, 32, 32, 5, 2058, 128, True, ENGINE_LENGTHS, "lengths"),
    ("verify9_int8", 4, 32, 32, 9, 2058, 128, True, ENGINE_LENGTHS, "lengths"),
    ("gqa_bf16", 1, 32, 8, 1, 1120, 128, False, (1100,), None),
    ("d64_int8", 2, 12, 12, 1, 600, 64, True, (600, 233), None),
)

# phase 3's cases at the LLM families' shapes (phase 4g serves them): K4 at each packed serving Linear that
# INT8_WEIGHTS does not already hold, (name, N, K) ...
FAMILY_K4_WEIGHTS = (
    ("llama2_7b_qkv", 12288, 4096), ("llama2_7b_gate_up", 22016, 4096),
    ("llama2_13b_qkv", 15360, 5120), ("llama2_13b_gate_up", 27648, 5120), ("llama2_13b_o", 5120, 5120),
    ("llama2_13b_down", 5120, 13824), ("llama2_13b_lm_head", 32064, 5120),
    ("llama3_8b_qkv", 6144, 4096), ("llama3_8b_gate_up", 28672, 4096), ("llama3_8b_down", 4096, 14336),
    ("llama3_8b_lm_head", 128320, 4096), ("llama31_8b_lm_head", 128256, 4096),
    ("qwen25_7b_qkv", 4608, 3584), ("qwen25_7b_gate_up", 37888, 3584), ("qwen25_7b_o", 3584, 3584),
    ("qwen25_7b_down", 3584, 18944), ("qwen25_7b_lm_head", 152064, 3584),
    ("qwen25_3b_qkv", 2560, 2048), ("qwen25_3b_gate_up", 22016, 2048), ("qwen25_3b_o", 2048, 2048),
    ("qwen25_3b_down", 2048, 11008),
)
FAMILY_K4_ROWS = (1, 4, 36)
FAMILY_K4_SHAPES = tuple((f"{w}_m{m}", m, n, k) for w, n, k in FAMILY_K4_WEIGHTS for m in FAMILY_K4_ROWS)
# ... K5 at the families' GQA groups (28 -> 4, 16 -> 2, 32 -> 8, 40 heads), decode and the verifies whose group x Tq
# rows cross a 16-row unit inside a head (7 x 3 = 21, 7 x 5 = 35, 8 x 3 = 24, 4 x 5 = 20), bf16 and int8 ...
FAMILY_K5_CASES = tuple(
    (f"{name}_{'int8' if int8 else 'bf16'}", B, H, Hk, Tq, Tk, 128, int8, lengths, offs)
    for name, B, H, Hk, Tq, Tk, lengths, offs in (
        ("qwen25_7b_b1", 1, 28, 4, 1, 1120, (1100,), None), ("qwen25_3b_b1", 1, 16, 2, 1, 1120, (1100,), None),
        ("llama3_8b_b1", 1, 32, 8, 1, 1120, (1100,), None), ("llama2_13b_b1", 1, 40, 40, 1, 1120, (1100,), None),
        ("qwen25_7b_verify3", 4, 28, 4, 3, 2058, ENGINE_LENGTHS, "lengths"),
        ("qwen25_7b_verify5", 4, 28, 4, 5, 2058, ENGINE_LENGTHS, "lengths"),
        ("qwen25_3b_verify3", 4, 16, 2, 3, 2058, ENGINE_LENGTHS, "lengths"),
        ("llama3_8b_verify5", 4, 32, 8, 5, 2058, ENGINE_LENGTHS, "lengths"))
    for int8 in (False, True))
# ... and K2 at the families' prefills (1,088 tokens into a 1,120-row cache) and Qwen-2.5-7B's suffix prefill
# (8 suffixes in a 64-token bucket at q_offset 1,024: no BOS before the 1,024 visual tokens)
FAMILY_FLASH_CASES = (
    ("qwen25_7b_cache_prefill", 1, 28, 4, 1088, 1120, 128, True, 0, "prefill"),
    ("qwen25_3b_cache_prefill", 1, 16, 2, 1088, 1120, 128, True, 0, "prefill"),
    ("llama2_13b_cache_prefill", 1, 40, 40, 1088, 1120, 128, True, 0, "prefill"),
    ("qwen25_7b_suffix_prefill", 8, 28, 4, 64, 1152, 128, True, 1024, "suffix"),
)


# ... and at tensor-parallel serving's shard shapes (phase 4j serves Llama-2-7B at tensor = 2): K2 at a rank's 16 of
# the 32 heads of the prefill, K4 at a rank's unpacked Linears (N, K): q / k / v (4096 / 2 outputs), o (2048 inputs),
# gate / up (11,008 / 2 outputs), down (5,504 inputs: 86 k-steps of 64), the lm_head's 16,032 of 32,064 columns (a
# ragged last 128-column tile), and down at tensor = 4 (2,752 inputs: 43 k-steps, a prime), at 1 and 4 rows; K5 at
# 16 heads, bf16 and int8, decode and the verify at 3 rows, B = 1 and the engine's 4 slots
TENSOR_FLASH_CASES = (("llama2_7b_tp2_cache_prefill", 1, 16, 16, 1088, 1120, 128, True, 0, "prefill"),)
TENSOR_K4_WEIGHTS = (("tp2_qkv", 2048, 4096), ("tp2_o", 4096, 2048), ("tp2_gate_up", 5504, 4096),
                     ("tp2_down", 4096, 5504), ("tp2_lm_head", 16032, 4096), ("tp4_down", 4096, 2752))
TENSOR_K4_SHAPES = tuple((f"{w}_m{m}", m, n, k) for w, n, k in TENSOR_K4_WEIGHTS for m in (1, 4))
TENSOR_K5_CASES = (
    ("tp2_b1_bf16", 1, 16, 16, 1, 1120, 128, False, (1100,), None),
    ("tp2_b1_int8", 1, 16, 16, 1, 1120, 128, True, (1100,), None),
    ("tp2_engine_int8", 4, 16, 16, 1, 2058, 128, True, ENGINE_LENGTHS, None),
    ("tp2_verify3_bf16", 4, 16, 16, 3, 2058, 128, False, ENGINE_LENGTHS, "lengths"),
)


def tensor_kernel_cases(dev, seed: int):
    """Phase 3 at tensor-parallel serving's shard shapes: K2 (TENSOR_FLASH_CASES),
    K4 (TENSOR_K4_SHAPES) and K5 (TENSOR_K5_CASES), each held against its
    plain version and timed beside its library call and its bound."""
    return (kernel_cases(dev, seed + 9, k1=False, flash_cases=TENSOR_FLASH_CASES)
            + int8_kernel_cases(dev, seed + 9, k4_shapes=TENSOR_K4_SHAPES, k5_cases=TENSOR_K5_CASES))


def rotating(calls):
    """One callable that runs ``calls[0]``, ``calls[1]``, ... in turn, one per call."""
    turn = [0]

    def call():
        out = calls[turn[0] % len(calls)]()
        turn[0] += 1
        return out

    return call


def cold_copies(bytes_per_call: int) -> int:
    """Copies of a call's inputs that together exceed ``COLD_BYTES``."""
    return max(1, -(-COLD_BYTES // max(int(bytes_per_call), 1)))


def kernel_launches(fn, strict: bool = True) -> dict:
    """The kernels one call of ``fn`` launches: the kernel nodes of a CUDA
    graph that captures one call, read through the CUDA driver API
    (``cuGraphGetNodes`` / ``cuGraphNodeGetType``), with ``torch.profiler``'s
    kernel names and count of 5 calls beside them (its records of
    ctypes-launched kernels can go missing, see ``device_ms``; the graph's
    nodes cannot). ``strict``:
    raise unless a call is exactly one kernel (a design of one launch a call;
    an older tree timed beside it is read, not held)."""
    import ctypes

    import torch
    from torch.profiler import ProfilerActivity, profile

    side = capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side, capture_error_mode="relaxed"):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds.append(kind.value)
    del graph
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    r = dict(graph_nodes=len(kinds), kernel_nodes=kinds.count(0),  # 0: CU_GRAPH_NODE_TYPE_KERNEL
             profiler_per_call=sum(e.count for e in events) / 5, profiler_names=sorted({e.key[:90] for e in events}))
    log(f"[launches] {r}")
    if strict and (r["kernel_nodes"] != 1 or r["graph_nodes"] != 1):
        raise RuntimeError(f"one call is not one kernel: {r}")
    return r


def int8_kernel_cases(dev, seed: int, k4_shapes=None, k5_cases=None):
    """K4 and K5 against their plain versions at the paths' shapes, each with
    CUDA-event and graph-replay times of the kernel and of its library
    yardstick (K4: the bf16 model's ``F.linear`` on the same shape, the call
    int8 has to beat; K5: SDPA on the bf16 cache with the same boolean mask,
    after the dequantization for an int8 cache), the plain time and the bound;
    both graph-replay times also L2-cold (``cold_graph_ms``,
    ``library_cold_graph_ms``: 20 calls rotating through ``cold_copies`` of the
    inputs, more than 50 MB together); the plan the wrapper picks (K4's
    splits, K5's cluster, and the residency it read); K4's and K5's kernels a
    call at one shape each (``kernel_launches``: one kernel node in a captured
    call); a planted fault in each (K4: the
    scales shifted by one column; K5: the causal offset off by one) must fail
    the same hold."""
    import torch
    import torch.nn.functional as F

    import merv_tpu_torch.ops.decode_attention as K5
    import merv_tpu_torch.ops.int8_linear as K4
    from merv_tpu_torch.models.backbones.llm.transformer import _quantize_kv
    from merv_tpu_torch.nn.quantization import quantize_kernel

    cases = []
    record = functools.partial(record_case, cases)

    def caught(kernel, name, fault, out, ref, mag):
        h = hold(out, ref, mag)
        log(f"[fault] {fault:24s} {kernel}/{name}: worst/limit {h['worst_share_of_limit']:.2f} -> "
            f"{'not caught' if h['ok'] else 'caught'}")
        if h["ok"]:
            raise RuntimeError(f"planted fault {fault} was not caught on {kernel}/{name}")
        return h["worst_share_of_limit"]

    # inputs from a seeded generator on the card (the lm_heads hold up to 545 M values a copy, too many to draw on
    # the host in time), each (N, K)'s weights and cold copies kept across its row counts
    gen = torch.Generator(device=dev).manual_seed(seed + 17)

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    weights = {}
    shapes = k4_shapes if k4_shapes is not None else \
        [(f"{w}_m{m}", m, n, k) for w, n, k in INT8_WEIGHTS for m in INT8_ROWS] + [INT8_RAGGED]
    for name, M, N, K in shapes:
        if (N, K) not in weights:
            weights.clear()
            w = rand((N, K)) * 0.02
            weights[(N, K)] = (w, *quantize_kernel(w),
                               [quantize_kernel(rand((N, K)) * 0.02) for _ in range(cold_copies(N * K) - 1)],
                               [rand((N, K)) for _ in range(cold_copies(2 * N * K) - 1)])
        w, q8, scale, kq, lw = weights[(N, K)]
        x = rand((M, K))
        out = K4.int8_linear(x, q8, scale)
        ref = K4.int8_linear_plain(x, q8, scale)
        mag = K4.int8_linear_plain(x.abs(), q8.abs(), scale)
        extra = {}
        if name in ("qkvo_m4", INT8_RAGGED[0]):
            extra["planted_scale_column_share"] = caught(
                "int8_linear", name, "k4_scale_column_shifted", out,
                K4.int8_linear_plain(x, q8, scale.roll(1)), K4.int8_linear_plain(x.abs(), q8.abs(), scale.roll(1)))
        if hasattr(K4, "int8_linear_plan"):
            idx = torch.cuda.current_device()
            res = K4._residency(idx, -(-M // 8))
            extra["splits"] = K4.int8_linear_plan(M, N, K, K4._sm_count(idx), res[0] // K4._sm_count(idx), res)
            extra["residency"] = list(res)
        if name == "qkvo_m1":
            extra["launches_per_call"] = kernel_launches(lambda: K4.int8_linear(x, q8, scale),
                                                         strict=hasattr(K4, "int8_linear_plan"))
        kernel_copies = [(q8, scale, x)] + [(qc, sc, rand((M, K))) for qc, sc in kq]
        lib_copies = [(w, x)] + [(wc, rand((M, K))) for wc in lw]
        extra["cold_copies"] = [len(kernel_copies), len(lib_copies)]
        extra["cold_graph_ms"] = graph_ms(rotating([functools.partial(K4.int8_linear, xc, qc, sc)
                                                    for qc, sc, xc in kernel_copies]))
        extra["library_cold_graph_ms"] = graph_ms(rotating([functools.partial(F.linear, xc, wc)
                                                            for wc, xc in lib_copies]))
        record("int8_linear", name, [M, N, K], out, ref, mag,
               lambda: K4.int8_linear(x, q8, scale), lambda: K4.int8_linear_plain(x, q8, scale),
               lambda: F.linear(x, w),
               bytes_moved=N * K + 4 * N + 2 * M * K + 2 * M * N, flops=2.0 * M * N * K, extra=extra,
               graph=("kernel", "library"))
        del w, q8, x, kq, lw, kernel_copies, lib_copies
    weights.clear()

    for name, B, H, Hk, Tq, Tk, D, int8, lengths, offs in (DECODE_CASES if k5_cases is None else k5_cases):
        q = rand((B, H, Tq, D))
        kf, vf = (rand((B, Hk, Tk, D)) for _ in range(2))
        length = torch.tensor(lengths, device=dev)
        kv_pos = torch.arange(Tk, device=dev)[None]
        # the decoder's key mask: the rows written (and the new ones), never a per-slot cache's scratch row
        mask = (kv_pos < length[:, None] + (Tq if offs else 1)) & (kv_pos < Tk - (1 if B == 4 else 0))
        if int8:
            (k8, ks), (v8, vs) = _quantize_kv(kf), _quantize_kv(vf)
            cache = (k8, v8, ks, vs)
            kd, vd = K5.dequantize_kv(k8, ks, torch.bfloat16), K5.dequantize_kv(v8, vs, torch.bfloat16)
        else:
            cache, kd, vd = (kf, vf), kf, vf
        kw = dict(kv_mask=mask, causal=offs is not None, q_offset=length if offs else None)
        out = K5.decode_attention(q, *cache, **kw)
        ref = K5.decode_attention_plain(q, *cache, **kw)
        mag = K5.decode_attention_plain(q, kd, vd.abs(), **kw)
        extra = {}
        if offs:
            kw_off = dict(kw, q_offset=length + 1)
            extra["planted_offset_share"] = caught("decode_attention", name, "k5_causal_offset_plus_one", out,
                                                   K5.decode_attention_plain(q, *cache, **kw_off),
                                                   K5.decode_attention_plain(q, kd, vd.abs(), **kw_off))
        valid = mask[:, None, :].expand(B, Tq, Tk)
        if offs:
            valid = valid & (kv_pos[:, None, :] <= torch.arange(Tq, device=dev)[None, :, None] + length[:, None, None])
        rows = int(mask.sum())  # cache rows a key of which some query sees: each read once per kv head
        row_bytes = 2 * D * (1 if int8 else 2) + (8 if int8 else 0)
        bytes_moved = rows * Hk * row_bytes + 2 * 2 * q.numel() + mask.numel()
        pairs = int(valid.sum()) * H
        kr, vr = (kd, vd) if Hk == H else (kd.repeat_interleave(H // Hk, 1), vd.repeat_interleave(H // Hk, 1))
        if int8:
            def library():
                k_, v_ = K5.dequantize_kv(k8, ks, torch.bfloat16), K5.dequantize_kv(v8, vs, torch.bfloat16)
                if Hk != H:
                    k_, v_ = k_.repeat_interleave(H // Hk, 1), v_.repeat_interleave(H // Hk, 1)
                return F.scaled_dot_product_attention(q, k_, v_, attn_mask=valid[:, None])
        else:
            def library():
                return F.scaled_dot_product_attention(q, kr, vr, attn_mask=valid[:, None])
        if hasattr(K5, "decode_plan"):
            idx = torch.cuda.current_device()
            res = K5._residency(idx, D, int8)
            extra["cluster"] = K5.decode_plan(B, Hk, H // Hk * Tq, Tk, K5._sm_count(idx), res[0] // K5._sm_count(idx),
                                              res)
            extra["residency"] = list(res)
        if name == "b1_bf16":
            extra["launches_per_call"] = kernel_launches(lambda: K5.decode_attention(q, *cache, **kw),
                                                         strict=hasattr(K5, "decode_plan"))

        def one_copy():
            kc, vc = rand((B, Hk, Tk, D)), rand((B, Hk, Tk, D))
            if not int8:
                return (kc, vc), (kc, vc)
            (k8c, ksc), (v8c, vsc) = _quantize_kv(kc), _quantize_kv(vc)
            return (k8c, v8c, ksc, vsc), (k8c, v8c, ksc, vsc)


        copies = [(cache, cache)] + [one_copy() for _ in range(cold_copies(bytes_moved) - 1)]

        def lib_call(c):
            if int8:
                k_, v_ = K5.dequantize_kv(c[0], c[2], torch.bfloat16), K5.dequantize_kv(c[1], c[3], torch.bfloat16)
            else:
                k_, v_ = c
            if Hk != H:
                k_, v_ = k_.repeat_interleave(H // Hk, 1), v_.repeat_interleave(H // Hk, 1)
            return F.scaled_dot_product_attention(q, k_, v_, attn_mask=valid[:, None])

        extra["cold_copies"] = len(copies)
        extra["cold_graph_ms"] = graph_ms(rotating([functools.partial(K5.decode_attention, q, *c, **kw)
                                                    for c, _ in copies]))
        extra["library_cold_graph_ms"] = graph_ms(rotating([functools.partial(lib_call, c) for _, c in copies]))
        record("decode_attention", name, [B, H, Hk, Tq, Tk, D, "int8" if int8 else "bf16"], out, ref, mag,
               lambda: K5.decode_attention(q, *cache, **kw), lambda: K5.decode_attention_plain(q, *cache, **kw),
               library, bytes_moved=bytes_moved, flops=4.0 * pairs * D, extra=dict(extra, valid_rows=rows),
               graph=("kernel", "library"))
        del q, kf, vf, kd, vd, kr, vr, cache, copies
    return cases


# Llama-2-7B's widths at a cut depth: the B = 1 decode step of --decode-step-only (its layers are identical, so
# a step's time is about LLM_LAYERS / DECODE_STEP_LAYERS times this one's)
DECODE_STEP_LAYERS = 8
DECODE_STEP_LLM = dict(vocab_size=32064, hidden_size=4096, intermediate_size=11008, num_layers=DECODE_STEP_LAYERS,
                       num_heads=32, num_kv_heads=32, head_dim=128, max_position_embeddings=4096)


def decode_step_probe(dev, seed: int, cache_rows: int = 1120, prompt: int = 1080, replays: int = 30) -> dict:
    """The B = 1 decode step (``DecodeRunner``'s graph) of Llama-2-7B's widths
    cut to ``DECODE_STEP_LAYERS`` layers on seeded random weights, bf16 and
    int8 (weights and cache), after a ``prompt``-token prefill into a
    ``cache_rows``-row cache (phase 4's request shape): ms per step by CUDA
    events over ``replays`` replays, the best of 3. Only the package's public
    decode path is used, so two trees' packages time alike (``chip_ab.sh``)."""
    import torch

    import merv_tpu_torch.models.generation as G
    from merv_tpu_torch.models.backbones.llm.transformer import LlamaDecoder, tiny_decoder_config
    from merv_tpu_torch.nn.core import init_weights
    from merv_tpu_torch.nn.quantization import quantize_tree

    out = {}
    for mode in ("bf16", "int8"):
        dec = LlamaDecoder(tiny_decoder_config(param_dtype=torch.bfloat16, **DECODE_STEP_LLM), device=dev)
        init_weights(dec, torch.Generator(device=dev).manual_seed(seed))
        if mode == "int8":
            dec = quantize_tree(dec)
        cfg = G.GenerationConfig(max_new_tokens=40, eos_token_id=-1, kv_cache_dtype="int8" if mode == "int8" else None)
        runner, _ = G.decode_runner(dec, 1, cache_rows, cfg, dev)
        ids = torch.randint(3, 32000, (1, prompt), device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
        mask = torch.ones((1, cache_rows), dtype=torch.bool, device=dev)
        with torch.inference_mode():
            logits, _, n_valid = G.prefill(dec, dec.embed_input_ids(ids), None, cache_rows, cache=runner.cache)
        first = logits.argmax(-1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ms = []
        for _ in range(4):
            runner.load(first, n_valid, mask, prompt, None)
            torch.cuda.synchronize()
            start.record()
            for _ in range(replays):
                runner.replay()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end) / replays)
        out[mode] = dict(ms_per_step=min(ms[1:]), readings=ms[1:], layers=DECODE_STEP_LAYERS)
        log(f"[decode-step] {mode}, {DECODE_STEP_LAYERS} layers of Llama-2-7B, B=1, {cache_rows} cache rows: "
            f"{out[mode]['ms_per_step']:.4f} ms/step by graph replay (readings {[round(m, 4) for m in ms[1:]]})")
        del runner, dec
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3, continued: K6 (layer_norm), the towers' LayerNorm in one pass
# ---------------------------------------------------------------------------

# (case, rows, width, eps): LanguageBind-L's rows at the align cell's micro-batch of 16 videos (16 frames x 257
# tokens each) and at one served video, ViViT-B's at 16 videos (3,137 tokens each), SigLIP so400m's at 16 frames of
# 256 tokens; each tower's eps
LAYER_NORM_CASES = (("align_languagebind", 65792, 1024, 1e-5), ("serve_languagebind", 4112, 1024, 1e-5),
                    ("align_vivit", 50192, 768, 1e-6), ("so400m_frames", 4096, 1152, 1e-6))


def layer_norm_cases(dev, seed: int, shapes=LAYER_NORM_CASES):
    """K6 against its plain version (``ops.layer_norm.layer_norm_plain``) at
    the towers' shapes, fp32 w and b as the towers store them: ``hold``, the
    share of elements bit-equal and the most bf16 ulps between the two; CUDA
    events and graph replay (``graph_ms``) of the kernel, the plain module's
    formula (``plain_graph_ms``) and one ``F.layer_norm`` call (the library,
    a yardstick the port never calls), beside the bytes bound (x read once, y
    written once). A graph replays 20 calls on one input: at the serving shape
    x and y (16 MB) stay in the 50 MB L2, so that reading is warm."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import merv_tpu_torch.ops.attention as A
    import merv_tpu_torch.ops.layer_norm as LN

    cases = []
    rng = np.random.default_rng(seed + 6)
    for name, rows, D, eps in shapes:
        x = (_randn(rng, (rows, D), dev) * 2 + 0.5).contiguous()
        w = torch.from_numpy(1 + 0.2 * rng.standard_normal(D).astype(np.float32)).to(dev)
        b = torch.from_numpy(0.2 * rng.standard_normal(D).astype(np.float32)).to(dev)
        before = A.launch_counts()
        out = LN.layer_norm_one_pass(x, w, b, eps)
        if A.launches_since(before) != {"layer_norm": 1}:
            raise RuntimeError(f"layer_norm/{name}: one call counted {A.launches_since(before)}")
        ref = LN.layer_norm_plain(x, w, b, eps)
        ulps = bf16_ulps(out, ref, layer_norm_terms(x, w, b, eps))
        plain = functools.partial(LN.layer_norm_plain, x, w, b, eps)
        extra = dict(ulps, eps=eps, plain_graph_ms=graph_ms(plain))
        record_case(cases, "layer_norm", name, [rows, D], out, ref, torch.zeros_like(ref),
                    functools.partial(LN.layer_norm_one_pass, x, w, b, eps), plain,
                    functools.partial(F.layer_norm, x, (D,), w.to(x.dtype), b.to(x.dtype), eps),
                    bytes_moved=2 * 2 * rows * D + 2 * 4 * D, flops=8 * rows * D, extra=extra,
                    graph=("kernel", "library"))
        c = cases[-1]
        c["roofline_share"] = c["bound_ms"] / c["graph_ms"]
        log(f"[kernel] layer_norm {name}: bit-equal {ulps['bit_equal_share']:.6f}, at most {ulps['max_ulps']:.3f} "
            f"bf16 ulps; graph {c['graph_ms']:.4f} ms against the bound {c['bound_ms']:.4f} ms "
            f"({100 * c['roofline_share']:.1f} %), plain graph {c['plain_graph_ms']:.4f}, F.layer_norm graph "
            f"{c['library_graph_ms']:.4f}")
        if ulps["max_ulps"] > 1.0:
            raise RuntimeError(f"layer_norm/{name}: {ulps['max_ulps']} bf16 ulps from the plain version")
        del x, out, ref
    return cases


# ---------------------------------------------------------------------------
# phase 4: the serving path
# ---------------------------------------------------------------------------


def build_merv_base(dev, seed: int, projector_dtype=None, llm_layers=None):
    """merv-base on random weights from a seeded generator on the card: towers
    and LLM stored in bf16; projectors and fusion in ``projector_dtype``
    (bf16 to serve, fp32 to train them); the LLM cut to ``llm_layers`` where
    given (full width)."""
    import dataclasses

    import torch

    import merv_tpu_torch.models.backbones.llm.base_llm as base_llm
    from merv_tpu_torch.benchkit import build_merv
    from merv_tpu_torch.conf import MERV_Base
    from merv_tpu_torch.device import make_generator

    cfg = MERV_Base()
    spec = base_llm.LLM_SPECS[cfg.llm_backbone_id]
    if llm_layers is not None:
        spec = dataclasses.replace(spec, decoder_config=dataclasses.replace(spec.decoder_config, num_layers=llm_layers))
    with patched((base_llm, "LLM_SPECS", dict(base_llm.LLM_SPECS, **{cfg.llm_backbone_id: spec}))):
        vidlm = build_merv(dataclasses.asdict(cfg), device=dev, generator=make_generator(dev, seed),
                           projector_dtype=projector_dtype or torch.bfloat16)
    return cfg, vidlm.eval()


def planted_faults():
    """Faulty stand-ins for the plain versions, as (module, name, function):
    kernel faults the checks should see, or show they cannot."""
    import torch

    import merv_tpu_torch.ops.attention as A

    small_plain, flash_plain = A.small_attention_kt_plain, A.flash_attention_forward_plain

    def k1_ragged_tail_dropped(q, kt, v, scale):
        # keys past the last whole 64-key tile ignored (DINOv2: 5 of 261, LanguageBind: 1 of 257)
        n = kt.shape[-1] // 64 * 64
        return small_plain(q, kt[..., :n].contiguous(), v[..., :n, :].contiguous(), scale)

    def k1_scores_in_bf16(q, kt, v, scale):
        s = torch.matmul(q, kt).float() * scale  # QK^T rounded to bf16 before the softmax
        p = torch.exp(s - s.amax(-1, keepdim=True))
        return (torch.matmul(p.to(v.dtype).float(), v.float()) / p.sum(-1, keepdim=True)).to(q.dtype)

    def k2_causal_top_left(q, k, v, *, causal, kv_mask=None, scale=None, q_offset=None, return_lse=False):
        # q_offset dropped: the cache prefill's queries see Tk - Tq = 32 keys ahead
        return flash_plain(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale, return_lse=return_lse)

    def k2_kv_mask_ignored(q, k, v, *, causal, kv_mask=None, scale=None, q_offset=None, return_lse=False):
        return flash_plain(q, k, v, causal=causal, scale=scale, q_offset=q_offset, return_lse=return_lse)

    return {
        "k1_ragged_tail_dropped": (A, "small_attention_kt_plain", k1_ragged_tail_dropped),
        "k1_scores_in_bf16": (A, "small_attention_kt_plain", k1_scores_in_bf16),
        "k2_causal_top_left": (A, "flash_attention_forward_plain", k2_causal_top_left),
        "k2_kv_mask_ignored": (A, "flash_attention_forward_plain", k2_kv_mask_ignored),
    }


def rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def show(held) -> str:
    return "; ".join(f"{name} {h['calls']} calls, worst/limit {h['worst_share_of_limit']:.3f}, "
                     f"mean err/mean limit {h['worst_mean_share']:.4f}"
                     + (f", at most {h['max_ulps']:.3f} bf16 ulps" if "max_ulps" in h else "")
                     for name, h in held.items())


def request_checks(vidlm, ids, mask, vids, is_mm, visual_len: int, max_new_tokens: int):
    """(run, run_held, compare) for one request's prepared inputs: ``run(impl)``
    gives the spliced embeddings and the prefill's last-position logits through
    the kernels (``"auto"``) or the plain versions (``"plain"``, every norm
    through the plain formula too); ``run_held()`` holds every kernel call of
    ``run("auto")`` (K1, K2 and K6) against its plain version; ``compare()``
    gives both runs' relative L2 difference and their greedy-token agreement."""
    import torch

    import merv_tpu_torch.ops.attention as A
    from merv_tpu_torch.models.generation import prefill

    def run(impl):
        with plain_norms() if impl == "plain" else contextlib.nullcontext():
            embeds, emask = vidlm.build_inputs_embeds(ids, mask, vids, is_mm, attn_impl=impl)
            if embeds.shape[1] != ids.shape[1] + visual_len:
                raise RuntimeError(f"spliced stream has {embeds.shape[1]} positions")
            logits, _, _ = prefill(vidlm.llm_backbone.decoder, embeds, emask.long(),
                                   embeds.shape[1] + max_new_tokens, attn_impl=impl)
        if not (torch.isfinite(embeds).all() and torch.isfinite(logits).all()):
            raise RuntimeError(f"non-finite embeddings or prefill logits (impl={impl})")
        return embeds.float(), logits.float()

    def run_held():
        """run("auto") with every kernel call held, by ``hold``, against the
        plain version (as the module holds it now) on the call's own inputs."""
        calls = {name: [] for name in SERVING_KERNELS + ("layer_norm",)}
        small, flash = A.small_attention_kt, A.flash_attention_forward

        def small_held(q, kt, v, scale):
            out = small(q, kt, v, scale)
            calls["small_attention_kt"].append(hold(out, A.small_attention_kt_plain(q, kt, v, scale),
                                                    A.small_attention_kt_plain(q, kt, v.abs(), scale)))
            return out

        def flash_held(q, k, v, **kw):
            out = flash(q, k, v, **kw)
            calls["flash_attention_forward"].append(hold(out, A.flash_attention_forward_plain(q, k, v, **kw),
                                                         A.flash_attention_forward_plain(q, k, v.abs(), **kw)))
            return out

        with patched((A, "small_attention_kt", small_held), (A, "flash_attention_forward", flash_held)), \
                held_layer_norms(calls["layer_norm"]):
            run("auto")
        return {name: held_summary(c) for name, c in calls.items()}

    def compare():
        """The request through the kernels and through the plain versions: the
        spliced embeddings and the prefill's last-position logits (relative
        L2) and the greedy tokens; and the plain run's embeddings and logits."""
        ref_embeds, ref_logits = run("plain")
        embeds, logits = run("auto")
        tok_auto = vidlm.generate_ids(ids, mask, vids, is_multimodal=is_mm, max_new_tokens=max_new_tokens)
        with plain_norms():
            tok_plain = vidlm.generate_ids(ids, mask, vids, is_multimodal=is_mm, max_new_tokens=max_new_tokens,
                                           attn_impl="plain")
        return dict(embeds_rel_diff=rel_l2(embeds, ref_embeds), logits_rel_diff=rel_l2(logits, ref_logits),
                    greedy_agreement=(tok_auto == tok_plain).float().mean().item(),
                    first_token_equal=bool((tok_auto[:, 0] == tok_plain[:, 0]).all())), ref_embeds, ref_logits

    return run, run_held, compare


def main_path(dev, seed: int, max_new_tokens: int):
    import numpy as np
    import torch

    import merv_tpu_torch.ops.attention as A

    t0 = time.perf_counter()
    cfg, vidlm = build_merv_base(dev, seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in vidlm.parameters())
    log(f"[main] built {cfg.model_id}: {n_params / 1e9:.3f} B params in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    questions = [
        "What is happening in this video?",
        "Describe the main object and its motion in detail.",
        "How many people appear, and what are they doing?",
    ]
    prompts = [vidlm.llm_backbone.prompt_builder_fn("merv").get_potential_prompt(q) for q in questions]
    rng = np.random.default_rng(seed + 1)
    videos = [rng.integers(0, 256, size=(32, 256, 320, 3), dtype=np.uint8) for _ in prompts]

    # warm-up request (cuBLAS handles, allocator), outside the counted window
    vidlm.generate(videos[0], prompts[0], max_new_tokens=2)
    torch.cuda.synchronize()

    A.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    requests = []
    texts = []
    for i, (video, prompt) in enumerate(zip(videos, prompts)):
        timings = {}
        t = time.perf_counter()
        text = vidlm.generate(video, prompt, max_new_tokens=max_new_tokens, timings=timings)
        # random weights: most ids fall outside the byte tokenizer's range and decode to nothing
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        steps = timings["decode_steps"]
        row = dict(request=i, wall_s=wall, prepare_s=timings["prepare_s"], towers_s=timings["towers_s"],
                   project_fuse_s=timings["project_fuse_s"], prefill_s=timings["prefill_s"],
                   decode_s=timings["decode_s"], decode_steps=steps, decode_capture_s=timings["decode_capture_s"],
                   decode_tokens_per_s=steps / timings["decode_s"] if steps else None, text=text)
        requests.append(row)
        texts.append(text)
        log(f"[main] request {i}: wall {wall:.3f} s = prepare {row['prepare_s']:.3f} + towers {row['towers_s']:.3f} "
            f"+ projector/fusion {row['project_fuse_s']:.4f} + prefill {row['prefill_s']:.3f} "
            f"+ decode {row['decode_s']:.3f} s ({steps} steps as CUDA-graph replays, "
            f"{row['decode_tokens_per_s']} tok/s) + graph capture {row['decode_capture_s']:.3f} s; "
            f"text {text[:40]!r}")

    # batched: a video row and a text-only row with a shorter prompt
    ids, mask, vids, is_mm = vidlm._prepare_batch_inputs([videos[0], None], [prompts[1], prompts[0][:12]])
    timings = {}
    t = time.perf_counter()
    batch_tokens = vidlm.generate_ids(ids, mask, vids, is_multimodal=is_mm, max_new_tokens=max_new_tokens,
                                      timings=timings)
    torch.cuda.synchronize()
    batch_wall = time.perf_counter() - t
    counts = A.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    vocab = vidlm.llm_backbone.decoder_config.vocab_size
    if tuple(batch_tokens.shape) != (2, max_new_tokens) or not bool(((batch_tokens >= 0) & (batch_tokens < vocab)).all()):
        raise RuntimeError(f"batched generate_ids: bad output {tuple(batch_tokens.shape)}")
    log(f"[main] batched generate_ids B=2 (video + text-only): wall {batch_wall:.3f} s, "
        f"prompt lengths {mask.sum(1).tolist()}, is_multimodal {is_mm.tolist()}")
    log(f"[main] launches during the main path: {counts}; peak memory {peak_gib:.2f} GiB")
    for kname in SERVING_KERNELS:
        if counts[kname] <= 0:
            raise RuntimeError(f"kernel {kname} was not launched on the serving path")

    # whole-path comparison with the plain versions (request 0)
    ids, mask, vids, is_mm = vidlm._prepare_batch_inputs([videos[0]], [prompts[0]])
    run, run_held, compare = request_checks(vidlm, ids, mask, vids, is_mm, cfg.visual_feature_length,
                                            max_new_tokens)
    checks, ref_embeds, ref_logits = compare()
    rel_embeds, rel_logits = checks["embeds_rel_diff"], checks["logits_rel_diff"]
    agree, first_equal = checks["greedy_agreement"], checks["first_token_equal"]
    held = run_held()
    log(f"[main] kernels vs plain: spliced input embeddings (towers, projectors, fusion) relative L2 diff "
        f"{rel_embeds:.3e} (tol {EMBEDS_REL_TOL}); prefill last-position logits {rel_logits:.3e} "
        f"(tol {LOGITS_REL_TOL}); greedy-token agreement {agree:.3f} over {max_new_tokens} tokens; "
        f"first token equal: {first_equal}")
    log(f"[main] each kernel call of request 0 against its plain version on its own inputs: {show(held)}")
    if not rel_embeds <= EMBEDS_REL_TOL:
        raise RuntimeError(f"kernel path embeddings differ from the plain path by {rel_embeds}")
    if not rel_logits <= LOGITS_REL_TOL:
        raise RuntimeError(f"kernel path logits differ from the plain path by {rel_logits}")
    for name, h in held.items():
        if h["calls"] == 0:
            raise RuntimeError(f"{name}: no call on request 0's path")
        if not h["ok"]:
            raise RuntimeError(f"{name}: a call on the main path is outside its limit against the plain version")

    # what the same checks give for a planted fault: one plain version swapped
    # for a faulty one, read on the whole path and call by call
    faults = {}
    for fname, fault in planted_faults().items():
        with patched(fault):
            f_embeds, f_logits = run("plain")
            f_held = run_held()
        fe, fl = rel_l2(f_embeds, ref_embeds), rel_l2(f_logits, ref_logits)
        faults[fname] = dict(embeds_rel_diff=fe, logits_rel_diff=fl, caught_whole_path=fe > EMBEDS_REL_TOL or
                             fl > LOGITS_REL_TOL, caught_call_by_call=not all(h["ok"] for h in f_held.values()),
                             held=f_held)
        log(f"[fault] {fname:24s} whole path: embeds {fe:.3e} logits {fl:.3e} -> "
            f"{'caught' if faults[fname]['caught_whole_path'] else 'not caught'}; call by call: {show(f_held)} -> "
            f"{'caught' if faults[fname]['caught_call_by_call'] else 'not caught'}")

    # the decode graph against the eager loop over the same step, from request 0's prefill
    graph_check = decode_graph_check(vidlm, ids, mask, vids, is_mm, max_new_tokens, seed)

    # the towers' routes, and request 0 served again with the switches on
    routes = tower_routes(vidlm, vids)
    switched = switched_requests(vidlm, videos[0], prompts[0], max_new_tokens, compare)
    return dict(model=cfg.model_id, params=n_params, requests=requests, batched_wall_s=batch_wall,
                batched_timings=timings, launches=counts, peak_memory_gib=peak_gib,
                embeds_rel_diff=rel_embeds, logits_rel_diff=rel_logits, held_call_by_call=held,
                greedy_agreement=agree, first_token_equal=first_equal, planted_faults=faults,
                decode_graph=graph_check, tower_routes=routes, switched_requests=switched)


# cuBLAS's GEMM and GEMV kernels by name (Hopper's nvjet and xmma kernels, CUTLASS-built ones, the GEMV fallbacks)
GEMM_KERNEL = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|splitk", re.IGNORECASE)


def profile_decode_step(advance) -> dict:
    """One decode step (``advance()``: an eager step or a graph replay) under
    ``torch.profiler``: the host wall from its launch to a device sync, the
    device time of its kernels, their count and the device's idle share;
    device time "not measured" (None) where the trace holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        advance()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if device_ms <= 0:
        return dict(wall_ms=wall_ms, device_ms=None, kernels=0, idle_share=None)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    gemms = [e for e in events if GEMM_KERNEL.search(e.key)]
    # one stream: kernels do not overlap, so busy time is their sum
    return dict(wall_ms=wall_ms, device_ms=device_ms, kernels=sum(e.count for e in events),
                gemm_kernels=sum(e.count for e in gemms), gemm_ms=sum(e.self_device_time_total for e in gemms) / 1e3,
                idle_share=1 - device_ms / wall_ms if device_ms <= wall_ms else None,
                top_kernels=[dict(kernel=e.key[:100], ms=e.self_device_time_total / 1e3, count=e.count) for e in top])


def decode_graph_check(vidlm, ids, mask, vids, is_mm, max_new_tokens: int, seed: int,
                       kv_cache_dtype=None, sampled: bool = True) -> dict:
    """Request 0's prefill written into its decode runner's cache, then the
    same steps from the same state twice: the eager loop over the runner's step
    function (run on the card for this check only) and the captured graph's
    replays. Their tokens must be equal and each step's logits equal to the
    bit or within DECODE_GRAPH_LOGITS_REL_TOL; both loops are timed (host
    clock between syncs, no copies) and one step of each is profiled. Then the
    same for a sampled decode (temperature 1, top-p 0.9) from one seed:
    whether graph and eager draw the same tokens is reported (unless
    ``sampled`` is False). ``kv_cache_dtype``: the runner's cache ("int8" or
    None, the compute dtype)."""
    import torch

    from merv_tpu_torch.models import generation as G

    dec = vidlm.llm_backbone.decoder
    out = {}
    with torch.inference_mode():
        embeds, emask = vidlm.build_inputs_embeds(ids, mask, vids, is_mm)
        B, T = embeds.shape[:2]
        for name, sample in (("greedy", False), ("sampled", True))[: 2 if sampled else 1]:
            cfg = vidlm._generation_config(max_new_tokens, sample, 1.0, 0.9 if sample else 1.0, 0, 1, kv_cache_dtype)
            runner, made = G.decode_runner(dec, B, T + max_new_tokens, cfg, embeds.device)
            logits, _, n_valid = G.prefill(dec, embeds, emask.long(), T + max_new_tokens, cache=runner.cache)
            first = logits.argmax(-1)
            cache_mask = torch.cat([emask.bool(), torch.ones((B, max_new_tokens), dtype=torch.bool,
                                                               device=emask.device)], dim=1)

            def start():
                gen = torch.Generator(device=embeds.device)
                gen.manual_seed(seed + 7)
                runner.load(first, n_valid, cache_mask, T, gen)

            def eager():
                return runner.step(dec)

            def replay():
                return runner.replay()

            runs = {}
            for mode, advance in (("eager", eager), ("graph", replay)):
                start()
                logits_by_step = torch.stack([advance().clone() for _ in range(max_new_tokens - 1)])
                runs[mode] = (runner.out.clone(), logits_by_step)
            tokens_equal = bool(torch.equal(runs["eager"][0], runs["graph"][0]))
            row = dict(capture_s=runner.capture_s if made else None, tokens_equal=tokens_equal,
                       launches_per_step=runner.launches_per_step)
            if name == "greedy":
                a, b = runs["graph"][1], runs["eager"][1]
                row.update(logits_bit_equal=bool(torch.equal(a, b)), logits_max_abs_diff=(a - b).abs().max().item(),
                           logits_rel_diff=rel_l2(a, b))
                for mode, advance in (("eager", eager), ("graph", replay)):
                    start()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    for _ in range(max_new_tokens - 1):
                        advance()
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t) * 1e3 / (max_new_tokens - 1)
                    start()
                    row[mode] = dict(ms_per_step=ms, tokens_per_s=1e3 / ms, profiled_step=profile_decode_step(advance))
            out[name] = row
            p_e, p_g = (row.get(m, {}).get("profiled_step", {}) for m in ("eager", "graph"))
            log(f"[decode] {name}: graph tokens equal the eager loop's: {tokens_equal}" + (
                "" if name != "greedy" else
                f"; step logits bit-equal {row['logits_bit_equal']} (max abs diff {row['logits_max_abs_diff']:.3e}, "
                f"rel L2 {row['logits_rel_diff']:.3e}, tol {DECODE_GRAPH_LOGITS_REL_TOL:g}); eager "
                f"{row['eager']['ms_per_step']:.2f} ms/step ({row['eager']['tokens_per_s']:.1f} tok/s), graph "
                f"{row['graph']['ms_per_step']:.2f} ms/step ({row['graph']['tokens_per_s']:.1f} tok/s); profiled "
                f"eager step: wall {p_e['wall_ms']:.2f} ms, device {p_e['device_ms']} ms in {p_e['kernels']} "
                f"kernels, idle share {p_e['idle_share']}; profiled replay: wall {p_g['wall_ms']:.2f} ms, device "
                f"{p_g['device_ms']} ms in {p_g['kernels']} kernels, idle share {p_g['idle_share']}; the replay's "
                f"largest kernels (ms, launches): "
                + "; ".join(f"{k['ms']:.3f} {k['count']} {k['kernel'][:60]}" for k in p_g.get("top_kernels", []))))
    g = out["greedy"]
    if not g["tokens_equal"]:
        raise RuntimeError("decode graph: greedy tokens differ from the eager loop's over the same step")
    if not (g["logits_bit_equal"] or g["logits_rel_diff"] <= DECODE_GRAPH_LOGITS_REL_TOL):
        raise RuntimeError(f"decode graph: step logits differ from the eager loop's by {g['logits_rel_diff']}")
    return out


# ---------------------------------------------------------------------------
# phase 4, continued: the towers' routes and the requests served on them
# ---------------------------------------------------------------------------

SWITCHES = ("MERV_TPU_TOWER_ATTN", "MERV_TPU_TEMPORAL_KERNEL", "MERV_TPU_FUSED_VIT_BLOCK")
# (route, the switches it sets); "default" sets none
TOWER_ROUTES = (
    ("default", {}),
    ("tower_attn_xla", {"MERV_TPU_TOWER_ATTN": "xla"}),
    ("tower_attn_xla_kt", {"MERV_TPU_TOWER_ATTN": "xla_kt"}),
    ("temporal_kernel", {"MERV_TPU_TEMPORAL_KERNEL": "1"}),
    ("fused_block", {"MERV_TPU_FUSED_VIT_BLOCK": "1"}),
)
TOWER_KERNELS = ("small_attention", "packed_temporal_attention", "fused_vit_attn_block")
# the two requests served with switches on, and the launches each must make
# (towers: DINOv2 23 and LanguageBind 23 layers, SigLIP 11, ViViT 12; the
# Llama prefill 32)
SWITCHED_REQUESTS = (
    ("tower_attn_xla+temporal_kernel", {"MERV_TPU_TOWER_ATTN": "xla", "MERV_TPU_TEMPORAL_KERNEL": "1"},
     {"small_attention": 46, "small_attention_kt": 0, "packed_temporal_attention": 23,
      "flash_attention_forward": 44, "fused_vit_attn_block": 0}),
    ("fused_block", {"MERV_TPU_FUSED_VIT_BLOCK": "1"},
     {"fused_vit_attn_block": 69, "small_attention_kt": 0, "flash_attention_forward": 32, "small_attention": 0,
      "packed_temporal_attention": 0}),
)


@contextlib.contextmanager
def switches(env: dict):
    """Set the towers' switches to ``env`` (the others unset) for the block."""
    saved = {name: os.environ.get(name) for name in SWITCHES}
    for name in SWITCHES:
        os.environ.pop(name, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def held_tower_run(vb, video) -> dict:
    """One tower forward with every B3, B5, B6 and K6 call held against the
    plain version (as the module holds it now) on the call's own inputs, by
    ``hold`` (B6: ``hold_fused``, end to end and stage by stage; K6: also
    ``bf16_ulps``); per kernel: calls, ok, worst share, worst mean share (B6:
    and the worst per stage; K6: the most ulps)."""
    import torch

    import merv_tpu_torch.ops.attention as A
    import merv_tpu_torch.ops.fused_vit_block as TF

    calls = {name: [] for name in TOWER_KERNELS + ("layer_norm",)}
    small, packed = A.small_attention, A.packed_temporal_attention

    def small_held(q, k, v, scale):
        out = small(q, k, v, scale)
        calls["small_attention"].append(hold(out, A.small_attention_plain(q, k, v, scale),
                                             A.small_attention_plain(q, k, v.abs(), scale)))
        return out

    def packed_held(q, kt, v, scale, heads):
        out = packed(q, kt, v, scale, heads)
        calls["packed_temporal_attention"].append(hold(out, A.packed_temporal_attention_plain(q, kt, v, scale, heads),
                                                       A.packed_temporal_attention_plain(q, kt, v.abs(), scale, heads)))
        return out

    def fused_held(*args):
        out, stages = TF.fused_vit_attn_block_stages(*args)
        calls["fused_vit_attn_block"].append(hold_fused(args, out, stages))
        return out

    with patched((A, "small_attention", small_held), (A, "packed_temporal_attention", packed_held),
                 (TF, "fused_vit_attn_block", fused_held)), held_layer_norms(calls["layer_norm"]), torch.no_grad():
        vb(video)
    out = {}
    for name, c in calls.items():
        if not c:
            continue
        out[name] = held_summary(c)
        if name == "fused_vit_attn_block":  # hold_fused's stages, worst over the calls
            out[name]["stages"] = {k: dict(worst_share_of_limit=max(x["stages"][k]["worst_share_of_limit"] for x in c))
                                   for k in c[0]["stages"]}
    return out


def tower_routes(vidlm, vids) -> dict:
    """Each tower at merv-base's batch shapes under the default route and
    under each switch: ms per tower (CUDA events), the output against the same
    route with impl="plain" and plain norms (relative L2 <= EMBEDS_REL_TOL),
    every B3/B5/B6/K6 call held against its plain version on its own inputs, and launches per
    tower. Then planted B5 and B6 faults, which the call-by-call check must
    catch (B3's kv-head fault needs GQA, which no tower has: its kernel case
    holds it)."""
    import torch

    import merv_tpu_torch.ops.attention as A

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    out = {}
    for route, env in TOWER_ROUTES:
        rows = {}
        with switches(env), torch.no_grad():
            for vb, v in zip(vidlm.video_backbones, vids):
                with plain_norms():
                    ref = vb(v, impl="plain")
                A.reset_launch_counts()
                got = vb(v)
                torch.cuda.synchronize()
                launches = {k: n for k, n in A.launch_counts().items() if n}
                ms = time_ms(lambda: vb(v), 10)
                held = held_tower_run(vb, v)
                r = rel(got, ref)
                rows[vb.identifier] = dict(ms=ms, rel_diff_plain=r, launches=launches, held=held)
                log(f"[route] {route:18s} {vb.identifier:36s} {ms:8.3f} ms per tower; vs plain {r:.3e}; launches "
                    f"{launches}; " + "; ".join(f"{k} {h['calls']} calls worst/limit {h['worst_share_of_limit']:.3f}"
                                                  + (f" ({stage_text(h)})" if "stages" in h else "")
                                                  for k, h in held.items()))
                if not torch.isfinite(got.float()).all() or not r <= EMBEDS_REL_TOL:
                    raise RuntimeError(f"route {route}, {vb.identifier}: output differs from plain by {r}")
                if not all(h["ok"] for h in held.values()):
                    raise RuntimeError(f"route {route}, {vb.identifier}: a kernel call is outside its limit")
        out[route] = rows

    faults = {}
    towers = {vb.identifier: (vb, v) for vb, v in zip(vidlm.video_backbones, vids)}
    for fname, tower, env, kernel in (("b5_mask_dropped", "languagebind-video-noclass", TOWER_ROUTES[3][1],
                                       "packed_temporal_attention"),
                                      ("b6_gamma_ignored", "dinov2-video-all-tokens", TOWER_ROUTES[4][1],
                                       "fused_vit_attn_block"),
                                      ("b6_scores_unscaled", "vivit-google-b-all-no-cls-16frames",
                                       TOWER_ROUTES[4][1], "fused_vit_attn_block")):
        vb, v = towers[tower]
        with switches(env), patched(planted_tower_faults()[fname]):
            held = held_tower_run(vb, v)[kernel]
        faults[fname] = dict(tower=tower, held=held, caught=not held["ok"])
        by_stage = "" if "stages" not in held else f" ({stage_text(held)})"
        log(f"[fault] {fname:24s} {tower} call by call: {held['calls']} calls, worst/limit "
            f"{held['worst_share_of_limit']:.2f}{by_stage} -> {'caught' if faults[fname]['caught'] else 'not caught'}")
        if not faults[fname]["caught"]:
            raise RuntimeError(f"planted fault {fname} was not caught on the {tower} route")
    out["planted_faults"] = faults
    return out


def switched_requests(vidlm, video, prompt, max_new_tokens: int, compare) -> dict:
    """The requests of SWITCHED_REQUESTS, each served through ``generate`` with
    its switches on and the launch counters zeroed just before and read just
    after, then held against its plain rerun by ``compare``."""
    import torch

    import merv_tpu_torch.ops.attention as A

    out = {}
    for name, env, expect in SWITCHED_REQUESTS:
        with switches(env):
            A.reset_launch_counts()
            timings = {}
            t = time.perf_counter()
            text = vidlm.generate(video, prompt, max_new_tokens=max_new_tokens, timings=timings)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = A.launch_counts()
            checks = compare()[0]
        row = dict(wall_s=wall, towers_s=timings["towers_s"], prefill_s=timings["prefill_s"],
                   decode_s=timings["decode_s"], launches=counts, text=text, **checks)
        out[name] = row
        log(f"[main] request with {name}: wall {wall:.3f} s, towers {row['towers_s']:.3f} s, prefill "
            f"{row['prefill_s']:.3f} s; launches {counts}; kernels vs plain: embeds {checks['embeds_rel_diff']:.3e} "
            f"(tol {EMBEDS_REL_TOL}), logits {checks['logits_rel_diff']:.3e} (tol {LOGITS_REL_TOL}), greedy-token "
            f"agreement {checks['greedy_agreement']:.3f}, first token equal: {checks['first_token_equal']}")
        wrong = {k: (counts[k], n) for k, n in expect.items() if counts[k] != n}
        if wrong:
            raise RuntimeError(f"request with {name}: launches (got, predicted) {wrong}")
        if not checks["embeds_rel_diff"] <= EMBEDS_REL_TOL or not checks["logits_rel_diff"] <= LOGITS_REL_TOL:
            raise RuntimeError(f"request with {name}: kernel path differs from the plain path beyond the limits")
    return out


# ---------------------------------------------------------------------------
# phase 4c: a run directory loaded by load_vid, a video file served
# ---------------------------------------------------------------------------

DEMO_VIDEO = os.path.join("assets", "video_demo.mp4")
SYNTHETIC_FRAMES = (32, 128, 128, 3)  # what load_video returns for the demo at max(num_frames)
# the loaded request's launches: K1 23 DINOv2 + 23 LanguageBind layers; K2 12 ViViT + 32 prefill layers
LOADED_REQUEST_LAUNCHES = {"small_attention_kt": 46, "flash_attention_forward": 44, "small_attention": 0,
                           "packed_temporal_attention": 0, "fused_vit_attn_block": 0}


def video_decoders(path: str) -> dict:
    """Which of the decode backends opens ``path`` here: {backend: "ok" or its error}."""
    from merv_tpu_torch.preprocessing import video_io

    out = {}
    for name in video_io.BACKENDS:
        try:
            video_io.open_video(path, backend=name).close()
            out[name] = "ok"
        except Exception as e:  # recorded: the phase reports which decoders the host lacks
            out[name] = f"{type(e).__name__}: {e}"[-400:]
    return out


def demo_video(seed: int):
    """(the demo video's path where a decoder opens it, else seeded synthetic
    frames of its decoded shape; the backend that opened it or "synthetic";
    what each backend gave, ``video_decoders``)."""
    from pathlib import Path

    import numpy as np

    decoders = video_decoders(DEMO_VIDEO)
    frames_from = next((name for name, state in decoders.items() if state == "ok"), "synthetic")
    video = Path(DEMO_VIDEO) if frames_from != "synthetic" else \
        np.random.default_rng(seed + 3).integers(0, 256, size=SYNTHETIC_FRAMES, dtype=np.uint8)
    return video, frames_from, decoders


def write_run_dir(run_dir: str, dev, seed: int, model: dict = None) -> dict:
    """``cli/make_randinit_run.py``'s run directory (``model``: merv-full's
    model dict unless given): config.json and fp32 projectors and fusion from
    a generator seeded with ``seed`` on the card, through the port's
    ``save_checkpoint``. Returns the saved state dicts."""
    from merv_tpu_torch.cli import make_randinit_run

    return make_randinit_run.write_run_dir(run_dir, dev, seed, MERV_FULL_MODEL if model is None else model)


def loaded_path(dev, seed: int, max_new_tokens: int, run_dir: str) -> dict:
    """Phase 4c: write a run directory, load it with ``load_vid`` (towers and
    LLM random from the port's seeded generator: the repository holds no
    weights), check what was loaded, then serve one request on the demo video
    (or on synthetic frames of its decoded shape where no decoder opens it)
    with the launches counted, held against its plain rerun as request 0 is."""
    import gc

    import torch

    import merv_tpu_torch.ops.attention as A
    from merv_tpu_torch import load_vid

    gc.collect()
    torch.cuda.empty_cache()
    saved = write_run_dir(run_dir, dev, seed)
    for name in ("MERV_TPU_TOWER_DIR", "MERV_TPU_LLM_DIR"):  # the random-weights route, whatever the caller set
        os.environ.pop(name, None)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    vidlm, cfg = load_vid(run_dir, get_model_cfg=True, allow_random_weights=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    load_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for key, state in saved.items():
        got = getattr(vidlm, key).state_dict()
        bad = [n for n, ref in state.items() if got[n].dtype != torch.float32 or not torch.equal(got[n].cpu(), ref)]
        if sorted(got) != sorted(state) or bad:
            raise RuntimeError(f"load_vid: {key} differ from the saved checkpoint (or are not fp32): {bad[:4]}")
    frozen = [(n, p) for n, p in vidlm.named_parameters() if n.split(".", 1)[0] in ("video_backbones", "llm_backbone")]
    bad = [n for n, p in frozen if p.is_floating_point() and (p.dtype != torch.bfloat16 or p.device.type != dev.type)]
    if bad:
        raise RuntimeError(f"load_vid: towers / LLM parameters not bf16 on the card: {bad[:4]}")
    log(f"[loaded] load_vid({run_dir}): {cfg.model_id}, {sum(p.numel() for p in vidlm.parameters()) / 1e9:.3f} B "
        f"params in {load_s:.1f} s, peak {load_peak_gib:.2f} GiB; projectors and fusion bit-identical to the "
        f"saved checkpoint (fp32); {len(frozen)} tower and LLM parameters bf16 on the card")

    video, frames_from, decoders = demo_video(seed)
    log(json.dumps({"video_decode": decoders, "frames_from": frames_from}))
    prompt = vidlm.llm_backbone.prompt_builder_fn("merv").get_potential_prompt("What is happening in this video?")
    vidlm.generate(video, prompt, num_frames=cfg.num_frames, max_new_tokens=2)  # warm-up, outside the counted window
    torch.cuda.synchronize()

    A.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t = time.perf_counter()
    text = vidlm.generate(video, prompt, num_frames=cfg.num_frames, max_new_tokens=max_new_tokens, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = A.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = timings["decode_steps"]
    request = dict(wall_s=wall, decode_video_s=timings.get("decode_video_s"), prepare_s=timings["prepare_s"],
                   towers_s=timings["towers_s"], project_fuse_s=timings["project_fuse_s"],
                   prefill_s=timings["prefill_s"], decode_s=timings["decode_s"], decode_steps=steps,
                   decode_capture_s=timings["decode_capture_s"],
                   decode_tokens_per_s=steps / timings["decode_s"] if steps else None, text=text)
    log(f"[loaded] request on {frames_from} frames: wall {wall:.3f} s = prepare {request['prepare_s']:.3f} "
        f"(host decode {request['decode_video_s']}) + towers {request['towers_s']:.3f} + projector/fusion "
        f"{request['project_fuse_s']:.4f} + prefill {request['prefill_s']:.3f} + decode {request['decode_s']:.3f} s "
        f"({steps} steps, {request['decode_tokens_per_s']} tok/s); launches {counts}; peak {peak_gib:.2f} GiB")
    wrong = {k: (counts[k], n) for k, n in LOADED_REQUEST_LAUNCHES.items() if counts[k] != n}
    if wrong:
        raise RuntimeError(f"loaded request: launches (got, predicted) {wrong}")

    ids, mask, vids, is_mm = vidlm._prepare_batch_inputs([video], [prompt], cfg.num_frames)
    # the request's greedy tokens: phase 4f's int8 model answers the same request beside them
    request["tokens"] = vidlm.generate_ids(ids, mask, vids, is_multimodal=is_mm,
                                           max_new_tokens=max_new_tokens)[0].tolist()
    _, run_held, compare = request_checks(vidlm, ids, mask, vids, is_mm, cfg.visual_feature_length, max_new_tokens)
    checks = compare()[0]
    held = run_held()
    log(f"[loaded] kernels vs plain: embeds {checks['embeds_rel_diff']:.3e} (tol {EMBEDS_REL_TOL}), logits "
        f"{checks['logits_rel_diff']:.3e} (tol {LOGITS_REL_TOL}), greedy-token agreement "
        f"{checks['greedy_agreement']:.3f}, first token equal: {checks['first_token_equal']}; call by call: {show(held)}")
    if not checks["embeds_rel_diff"] <= EMBEDS_REL_TOL or not checks["logits_rel_diff"] <= LOGITS_REL_TOL:
        raise RuntimeError("loaded request: kernel path differs from the plain path beyond the limits")
    for name, h in held.items():
        if h["calls"] == 0 or not h["ok"]:
            raise RuntimeError(f"loaded request: {name} has no call or a call outside its limit against plain")
    del vidlm
    shutil.rmtree(run_dir, ignore_errors=True)
    return dict(model=cfg.model_id, load_s=load_s, load_peak_memory_gib=load_peak_gib, request=request,
                launches=counts, peak_memory_gib=peak_gib, video_decode=decoders, frames_from=frames_from,
                held_call_by_call=held, **checks)


# ---------------------------------------------------------------------------
# phase 4d: the evaluation path (the port's eval drivers on a loaded run directory)
# ---------------------------------------------------------------------------

EVAL_RUN = "chip_smoke_eval"  # runs/<EVAL_RUN> (the run directory), eval_result/<EVAL_RUN> (the drivers' files)
EVAL_MAX_NEW_TOKENS = 64
# (label, driver, dataset, arguments, K1 / K2 launches predicted). Per video row batch: K1 23 DINOv2 + 23
# LanguageBind layers (one launch a layer for the whole batch), K2 12 ViViT layers + 32 LLM layers (the cache
# prefill, score_options' no-cache forward, or build_video_prefix's [BOS | visual] prefill); the shared path adds
# 32 K2 launches for each suffix prefill. dummy_mcq: 6 questions on 6 videos; batch 2 -> 3 groups, shared -> one
# video a group, 6 groups. dummy_openended_scaled: 32 questions on 4 videos, batch 8 -> 4 groups a pass, 2 passes.
EVAL_RUNS = (
    ("mcq_naive_b2", "eval_mcq", "dummy_mcq", dict(strategy="naive", batch_size=2),
     {"small_attention_kt": 3 * 46, "flash_attention_forward": 3 * 44}),
    ("mcq_likelihood_b2", "eval_mcq", "dummy_mcq", dict(strategy="likelihood", batch_size=2),
     {"small_attention_kt": 3 * 46, "flash_attention_forward": 3 * 44}),
    ("mcq_naive_b2_shared", "eval_mcq", "dummy_mcq", dict(strategy="naive", batch_size=2, share_video_prefix=True),
     {"small_attention_kt": 6 * 46, "flash_attention_forward": 6 * (44 + 32)}),
    ("openended_scaled_b8", "eval_openended", "dummy_openended_scaled", dict(batch_size=8, serving_passes=2),
     {"small_attention_kt": 8 * 46, "flash_attention_forward": 8 * 44}),
)
# generate_batch against generate_batch_shared on scene_0's 8 questions, one call each
SHARED_CHECK_LAUNCHES = {"batch": {"small_attention_kt": 46, "flash_attention_forward": 44},
                         "shared": {"small_attention_kt": 46, "flash_attention_forward": 44 + 32}}


class _ErrorRecords(logging.Handler):
    """Keeps the messages of the ERROR records it is handed."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        if record.levelno >= logging.ERROR:
            self.messages.append(record.getMessage())


def eval_driver_run(label, driver, dataset, args, predicted, errors) -> dict:
    """One driver run through its command line (``evaluate(args=...)``) on the
    run directory ``runs/<EVAL_RUN>``: its wall, launches, answers and logged
    failures; raises if a question has no ``pred``, a group or item failed
    (the drivers' per-item fault tolerance must not hide a kernel or capture
    fault on the card), or the launches differ from ``predicted``."""
    import io

    import torch

    import merv_tpu_torch.ops.attention as A
    from merv_tpu_torch.cli import eval_mcq, eval_openended

    module = {"eval_mcq": eval_mcq, "eval_openended": eval_openended}[driver]
    result_dir = os.path.join("eval_result", EVAL_RUN)
    shutil.rmtree(result_dir, ignore_errors=True)  # stale shards would satisfy the resume and merge
    argv = ["--model_path", EVAL_RUN, "--eval_dataset", dataset, "--max_new_tokens", str(EVAL_MAX_NEW_TOKENS),
            "--allow_random_weights", "true"] + [a for k, v in args.items() for a in (f"--{k}", str(v))]
    errors.messages.clear()
    A.reset_launch_counts()
    printed = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        module.evaluate(args=argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {k: A.launch_counts()[k] for k in predicted}
    lines = printed.getvalue().strip().splitlines()
    questions = {q["question_id"] for q in json.load(open(os.path.join("eval_data", dataset, "test_q.json")))}
    merged = (f"{dataset}_{args.get('strategy', 'naive')}_pred_merge.jsonl" if driver == "eval_mcq"
              else f"{dataset}_pred_merge.jsonl")
    merged_path = os.path.join(result_dir, merged)
    rows = [json.loads(line) for line in open(merged_path) if line.strip()] if os.path.exists(merged_path) else []
    missing = sorted(questions - {r["question_id"] for r in rows if isinstance(r.get("pred"), str)})
    serving = next((json.loads(line) for line in reversed(lines) if line.startswith("{") and "serving_wall_s" in line),
                   None)
    flops_path = os.path.join(result_dir, "flops.json")
    row = dict(label=label, driver=driver, dataset=dataset, args=args, wall_s=wall, questions=len(questions),
               questions_per_s=len(questions) / wall, launches=counts, predicted_launches=predicted,
               failures=list(errors.messages), missing=missing, printed=lines[-4:], serving=serving,
               flops=json.load(open(flops_path)) if os.path.exists(flops_path) else None,
               preds={r["question_id"]: r["pred"][:60] for r in rows})
    os.makedirs(os.path.join("chiprun_out", "eval"), exist_ok=True)
    if os.path.exists(merged_path):
        shutil.copy(merged_path, os.path.join("chiprun_out", "eval", f"{label}_{merged}"))
    log(f"[eval] {label}: python -m merv_tpu_torch.cli.{driver} {' '.join(argv)}: wall {wall:.2f} s for "
        f"{len(questions)} questions ({row['questions_per_s']:.3f} q/s, model load and graph captures included); "
        f"serving {serving}; launches {counts} (predicted {predicted}); {len(rows)} answers, missing {missing}; "
        f"failures {row['failures'][:3]}; printed {lines[-3:]}; flops {row['flops']}")
    if row["failures"] or missing:
        raise RuntimeError(f"eval {label}: failed groups or items {row['failures'][:3]}, unanswered {missing}")
    if counts != predicted:
        raise RuntimeError(f"eval {label}: launches {counts}, predicted {predicted}")
    return row


def shared_vs_batch(run_dir: str) -> dict:
    """scene_0's 8 questions of dummy_openended_scaled through generate_batch
    (8 full prefills of [BOS | visual | question]) and generate_batch_shared
    (one [BOS | visual] prefix, 8 suffix prefills at q_offset 1025): each row's
    last-position logits of the two prefills (recorded where generation calls
    them) held to LOGITS_REL_TOL, the greedy tokens' agreement, and each
    call's launches against SHARED_CHECK_LAUNCHES."""
    import torch

    import merv_tpu_torch.models.generation as G
    import merv_tpu_torch.models.vidlms.merv as M
    import merv_tpu_torch.ops.attention as A
    from merv_tpu_torch import load_vid

    vidlm, cfg = load_vid(run_dir, get_model_cfg=True, allow_random_weights=True)
    dataset = os.path.join("eval_data", "dummy_openended_scaled")
    prompts = []
    for q in json.load(open(os.path.join(dataset, "test_q.json"))):
        if q["video_name"] == "scene_0":
            builder = vidlm.llm_backbone.prompt_builder_fn(model_family="merv")
            builder.add_turn(role="human", message=q["question"])
            prompts.append(builder.get_prompt())
    video = M._load_media(os.path.join(dataset, "videos", "scene_0.gif"), max(cfg.num_frames))
    seen = {}

    def recorded(fn, key, first):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen[key] = (out[0] if first else out).clone()
            return out
        return call

    calls = {
        "batch": lambda: vidlm.generate_batch([video] * len(prompts), prompts, num_frames=cfg.num_frames,
                                              max_new_tokens=EVAL_MAX_NEW_TOKENS),
        "shared": lambda: vidlm.generate_batch_shared(video, prompts, num_frames=cfg.num_frames,
                                                      max_new_tokens=EVAL_MAX_NEW_TOKENS),
    }
    out = dict(questions=len(prompts))
    with patched((G, "prefill", recorded(G.prefill, "logits", True)),
                 (G, "prefill_with_prefix", recorded(G.prefill_with_prefix, "logits", True)),
                 (M, "_generate", recorded(M._generate, "tokens", False)),
                 (M, "generate_with_prefix", recorded(M.generate_with_prefix, "tokens", False))):
        for name, call in calls.items():
            A.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            texts = call()
            torch.cuda.synchronize()
            out[name] = dict(wall_s=time.perf_counter() - t, launches={k: A.launch_counts()[k] for k in
                                                                     SHARED_CHECK_LAUNCHES[name]},
                             logits=seen.pop("logits").float(), tokens=seen.pop("tokens"), texts=texts)
    full, shared = out["batch"], out["shared"]
    rows = [rel_l2(shared["logits"][b], full["logits"][b]) for b in range(len(prompts))]
    agree = (shared["tokens"] == full["tokens"]).float().mean().item()
    first = int((shared["tokens"][:, 0] == full["tokens"][:, 0]).sum().item())
    for name in calls:
        out[name] = {k: v for k, v in out[name].items() if k not in ("logits", "tokens")}
    out.update(logits_rel_diff_by_row=rows, greedy_agreement=agree, first_tokens_equal=first)
    log(f"[eval] generate_batch_shared against generate_batch on scene_0's {len(prompts)} questions: last-position "
        f"logits relative L2 by row {[round(r, 5) for r in rows]} (tol {LOGITS_REL_TOL}); greedy-token agreement "
        f"{agree:.3f} over {EVAL_MAX_NEW_TOKENS} tokens, first tokens equal in {first} of {len(prompts)} rows; walls "
        f"{full['wall_s']:.3f} / {shared['wall_s']:.3f} s; launches {full['launches']} / {shared['launches']}")
    del vidlm
    if not max(rows) <= LOGITS_REL_TOL:
        raise RuntimeError(f"shared-prefix logits differ from the full prefill's by {max(rows)}")
    for name, predicted in SHARED_CHECK_LAUNCHES.items():
        if out[name]["launches"] != predicted:
            raise RuntimeError(f"{name}: launches {out[name]['launches']}, predicted {predicted}")
    return out


def eval_path(dev, seed: int) -> dict:
    """Phase 4d: write merv-full's run directory (as phase 4c does) to
    ``runs/<EVAL_RUN>``, run the port's eval drivers on it through their
    command lines (EVAL_RUNS), then hold generate_batch_shared against
    generate_batch (``shared_vs_batch``). The run directory and the drivers'
    files are deleted at the end; the merged predictions are copied to
    ``chiprun_out/eval/``."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    run_dir = os.path.join("runs", EVAL_RUN)
    write_run_dir(run_dir, dev, seed)
    for name in ("MERV_TPU_TOWER_DIR", "MERV_TPU_LLM_DIR"):  # the random-weights route, whatever the caller set
        os.environ.pop(name, None)
    errors = _ErrorRecords()
    logging.getLogger("merv_tpu_torch").addHandler(errors)
    t = time.perf_counter()
    try:
        runs = []
        for label, driver, dataset, args, predicted in EVAL_RUNS:
            runs.append(eval_driver_run(label, driver, dataset, args, predicted, errors))
            gc.collect()
            torch.cuda.empty_cache()
        shared = shared_vs_batch(run_dir)
    finally:
        logging.getLogger("merv_tpu_torch").removeHandler(errors)
        shutil.rmtree(run_dir, ignore_errors=True)
        shutil.rmtree(os.path.join("eval_result", EVAL_RUN), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t
    log(f"[eval] phase 4d: {wall:.1f} s")
    return dict(wall_s=wall, runs=runs, shared_vs_batch=shared)


# ---------------------------------------------------------------------------
# phase 4i: sequence-parallel serving
# ---------------------------------------------------------------------------

SP_RUN = "chip_smoke_sp"  # runs/<SP_RUN> (merv-full's run directory), eval_result/sp_* (the drivers' files)
# (a) K5 with its LSE on the shards of a cache: (name, shards, batch, heads, kv heads, query rows, int8, positions a
# shard, scratch row, each batch row's first query position, a pad hole (batch row, first key, end) or None). A shard
# with a scratch row has one more buffer row, never valid (the sharded decoder's layout, CacheShards); the decode
# (one query row) runs uncausal under the key mask, as the decoder sends it, the verify causal at the offsets. At 700
# over 4 shards of 512, shards 2 and 3 lie wholly after the queries: every row there has no valid key (0 and -inf).
SP_K5_CASES = (
    ("n2_decode_bf16", 2, 1, 32, 32, 1, False, 1024, False, (1500,), None),
    ("n2_verify5_int8", 2, 1, 32, 32, 5, True, 1024, False, (1500,), None),
    ("n4_decode_int8", 4, 1, 32, 32, 1, True, 512, False, (700,), None),
    ("n4_verify5_bf16", 4, 1, 32, 32, 5, False, 512, False, (700,), None),
    # 4i(c)'s group path on a rank: 3 rows over shards of 552 positions + the scratch row, ragged, one padded
    ("n2_b3_553_decode_bf16", 2, 3, 32, 32, 1, False, 552, True, (1087, 1040, 700), (1, 60, 100)),
    # the engine's 4 slots over shards of 1,024 + 1 at per-slot offsets (a [B] tensor), the verify's 5 rows: slot
    # 0 has no key on shard 1, slot 2's queries straddle the shards' edge
    ("n2_b4_1025_verify5_int8", 2, 4, 32, 32, 5, True, 1024, True, (100, 1010, 1022, 1700), None),
    # GQA 32 -> 8 (Llama-3.1-8B): a kv head's 4 x 5 = 20 query rows split over two 16-row units
    ("n2_gqa8_verify5_bf16", 2, 1, 32, 8, 5, False, 1024, False, (1500,), None),
)
SP_K5_TIMED_ROWS = (1120, 1100)  # today's unsharded decode shape: cache rows, valid rows
# (b) the ring at memory_proof's --seq-len 8192: (label, heads, kv heads) over SP_RING_RANKS in-process ranks
SP_RING_SEQ = 8192
SP_RING_SHAPES = (("llama2_7b", 32, 32), ("llama31_8b_gqa", 32, 8))
SP_RING_RANKS = (2, 4)
# (c) eval_openended --mesh_seq 2 as two ranks on the one card over gloo, against the same run at sp = 1. 16 new
# tokens: the group path's cache (a 64-multiple prompt bucket + 16) tiles 2; the engine rounds its rows up itself.
SP_RANKS = 2
SP_EVAL_DATASET = "dummy_openended"
SP_EVAL_MAX_NEW = 16
SP_EVAL_RUNS = (("group", ["--batch_size", "3"]), ("engine", ["--use_engine", "true"]))
SP_WORKER_TIMEOUT_S = 600


def lse_check(lse, ref) -> dict:
    """K5's LSE against its plain version's: -inf on exactly the same rows
    (no valid key in the shard), the finite rows within LSE_REL_TOL."""
    import torch

    lse, ref = lse.float(), ref.float()
    empty = torch.isneginf(ref)
    same = bool(torch.equal(torch.isneginf(lse), empty))
    err = (lse[~empty] - ref[~empty]).abs()
    share = (err / (LSE_REL_TOL * (1 + ref[~empty].abs()))).max().item() if err.numel() else 0.0
    return dict(worst_share_of_limit=share, empty_rows=int(empty.sum()), same_empty_rows=same,
                ok=same and share <= 1.0)


def sp_k5_inputs(case, rng, dev) -> dict:
    """One SP_K5_CASES entry's inputs: q, the cache buffer in the sharded
    layout (each shard's positions, then its scratch row where the case has
    one), each shard's (k, v, k_scale, v_scale) and call arguments, and the
    same positions as one unsharded cache with its arguments."""
    import torch

    from merv_tpu_torch.models.backbones.llm.transformer import _quantize_kv

    name, n, B, H, Hk, Tq, int8, P, scratch, firsts, hole = case
    W = P + int(scratch)
    q = _randn(rng, (B, H, Tq, 128), dev)
    kf, vf = (_randn(rng, (B, Hk, n * W, 128), dev) for _ in range(2))
    if int8:
        (k8, ks), (v8, vs) = _quantize_kv(kf), _quantize_kv(vf)
        bufs = (k8, v8, ks, vs)
    else:
        bufs = (kf, vf, None, None)
    first = torch.tensor(firsts, device=dev)
    mask = torch.arange(n * P, device=dev)[None] < first[:, None] + Tq
    if hole is not None:
        mask[hole[0], hole[1]:hole[2]] = False
    causal = Tq > 1
    off = (first if B > 1 else firsts[0]) if causal else None
    shards = [tuple(None if t is None else t[:, :, r * W:(r + 1) * W].contiguous() for t in bufs) for r in range(n)]
    masks = [torch.cat([mask[:, r * P:(r + 1) * P], mask.new_zeros((B, W - P))], 1).contiguous() for r in range(n)]
    kws = [dict(kv_mask=masks[r], causal=causal, q_offset=None if off is None else off - r * P) for r in range(n)]
    whole = tuple(None if t is None else torch.cat([t[:, :, r * W:r * W + P] for r in range(n)], 2).contiguous()
                  for t in bufs)
    return dict(name=name, n=n, rows=P, q=q, shards=shards, masks=masks, kws=kws, whole=whole,
                kw_whole=dict(kv_mask=mask, causal=causal, q_offset=off), causal=causal, off=off)


def k5_lse_hold(q, k, v, k_scale, v_scale, kw, o, lse) -> dict:
    """K5's output and LSE (``o``, ``lse``) against its plain version on the
    same inputs: the output by ``hold`` (magnitudes from |V|), the LSE by
    ``lse_check``, and every output finite."""
    import torch

    import merv_tpu_torch.ops.decode_attention as K5

    ro, rl = K5.decode_attention_plain(q, k, v, k_scale, v_scale, return_lse=True, **kw)
    if k_scale is not None:
        k, v = K5.dequantize_kv(k, k_scale, q.dtype), K5.dequantize_kv(v, v_scale, q.dtype)
    mag = K5.decode_attention_plain(q, k, v.abs(), return_lse=True, **kw)[0]
    out, lh = hold(o, ro, mag), lse_check(lse, rl)
    finite = bool(torch.isfinite(o.float()).all())
    return dict(out=out, lse=lh, finite=finite, ok=out["ok"] and lh["ok"] and finite)


def sp_k5_cases(dev, seed: int) -> list:
    """Phase 4i(a): every shard's K5 call with its LSE held against the plain
    version (``k5_lse_hold``); the shards merged (``cache_shard_attention``
    over in-process ranks) held against unsharded K5 on the same positions;
    then K5 with and without the LSE output at today's unsharded decode shape
    (graph replay, warm and L2-cold, in turns)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import merv_tpu_torch.ops.decode_attention as K5
    import merv_tpu_torch.ops.ring_attention as R
    from merv_tpu_torch.models.backbones.llm.transformer import _quantize_kv

    rng = np.random.default_rng(seed + 41)
    cases, shard_checks = [], []
    for case in SP_K5_CASES:
        x = sp_k5_inputs(case, rng, dev)
        name, n, P, q = x["name"], x["n"], x["rows"], x["q"]
        for r, (sh, kw) in enumerate(zip(x["shards"], x["kws"])):
            o, lse = K5.decode_attention(q, *sh, return_lse=True, **kw)
            torch.cuda.synchronize()
            h = k5_lse_hold(q, *sh, kw, o, lse)
            shard_checks.append(dict(case=name, shard=r, first_key=r * P, shape=list(sh[0].shape), out=h["out"],
                                     lse=h["lse"]))
            log(f"[sp] K5+LSE {name} shard {r} (positions {r * P}-{(r + 1) * P - 1}, buffer {list(sh[0].shape)}): "
                f"out worst/limit {h['out']['worst_share_of_limit']:.3f}, lse worst/limit "
                f"{h['lse']['worst_share_of_limit']:.3f}, empty rows {h['lse']['empty_rows']} "
                f"(same: {h['lse']['same_empty_rows']})")
            if not h["ok"]:
                raise RuntimeError(f"K5 with LSE, {name} shard {r}: outside its limits against the plain version")
        merged = R.cache_shard_attention(q, x["shards"], x["masks"], R.VirtualRanks(n), P, causal=x["causal"],
                                         q_offset=x["off"])
        whole, kw_whole = tuple(t for t in x["whole"] if t is not None), x["kw_whole"]
        ref = K5.decode_attention(q, *whole, **kw_whole)
        kd, vd = whole[:2] if len(whole) == 2 else (K5.dequantize_kv(whole[0], whole[2], q.dtype),
                                                    K5.dequantize_kv(whole[1], whole[3], q.dtype))
        mag = K5.decode_attention_plain(q, kd, vd.abs(), **kw_whole)
        torch.cuda.synchronize()
        h = hold(merged, ref, mag)
        shard_checks.append(dict(case=name, merged_against_unsharded_k5=h))
        log(f"[sp] K5+LSE {name}: {n} shards merged by LSE against unsharded K5 on the same positions: worst/limit "
            f"{h['worst_share_of_limit']:.3f}, max err {h['max_abs_err']:.3e}")
        if not h["ok"]:
            raise RuntimeError(f"K5 with LSE, {name}: the merged shards differ from unsharded K5")
        del x, merged, ref, mag

    rows, valid = SP_K5_TIMED_ROWS
    for int8 in (False, True):
        q = _randn(rng, (1, 32, 1, 128), dev)

        def make():
            kc, vc = _randn(rng, (1, 32, rows, 128), dev), _randn(rng, (1, 32, rows, 128), dev)
            if not int8:
                return (kc, vc), (kc, vc)
            (k8, ks), (v8, vs) = _quantize_kv(kc), _quantize_kv(vc)
            return (k8, v8, ks, vs), (K5.dequantize_kv(k8, ks, torch.bfloat16), K5.dequantize_kv(v8, vs, torch.bfloat16))

        cache, (kd, vd) = make()
        kw = dict(kv_mask=(torch.arange(rows, device=dev) < valid)[None].contiguous())
        o, lse = K5.decode_attention(q, *cache, return_lse=True, **kw)
        ro, rl = K5.decode_attention_plain(q, *cache, return_lse=True, **kw)
        mag = K5.decode_attention_plain(q, kd, vd.abs(), return_lse=True, **kw)[0]
        row_bytes = 2 * 128 * (1 if int8 else 2) + (8 if int8 else 0)
        bytes_moved = valid * 32 * row_bytes + 2 * 2 * q.numel() + rows + 4 * 32
        copies = [cache] + [make()[0] for _ in range(cold_copies(bytes_moved) - 1)]
        plain = lambda c, lse_out: functools.partial(K5.decode_attention, q, *c, return_lse=lse_out, **kw)  # noqa: E731
        extra = dict(cold_copies=len(copies), lse=lse_check(lse, rl))
        for turn, lse_out in enumerate((False, True, True, False)):  # the two variants in turns
            key = "lse" if lse_out else "no_lse"
            extra.setdefault(f"{key}_graph_ms", []).append(graph_ms(plain(cache, lse_out)))
            extra.setdefault(f"{key}_cold_graph_ms", []).append(graph_ms(rotating([plain(c, lse_out) for c in copies])))
        extra["graph_ms"], extra["cold_graph_ms"] = min(extra["lse_graph_ms"]), min(extra["lse_cold_graph_ms"])
        kr, vr = kd, vd

        def library():
            return F.scaled_dot_product_attention(q, kr, vr, attn_mask=kw["kv_mask"][:, None, None])

        name = f"b1_{'int8' if int8 else 'bf16'}_{rows}"
        record_case(cases, "decode_attention_lse", name, [1, 32, 32, 1, rows, 128, "int8" if int8 else "bf16"], o, ro,
                    mag, lambda: K5.decode_attention(q, *cache, return_lse=True, **kw),
                    lambda: K5.decode_attention_plain(q, *cache, return_lse=True, **kw), library,
                    bytes_moved=bytes_moved, flops=4.0 * valid * 32 * 128, extra=extra)
        log(f"[sp] K5 at {rows} rows ({'int8' if int8 else 'bf16'}), graph ms without / with the LSE output, in turns: "
            f"warm {extra['no_lse_graph_ms']} / {extra['lse_graph_ms']}, L2-cold {extra['no_lse_cold_graph_ms']} / "
            f"{extra['lse_cold_graph_ms']}")
        del copies, cache
    return cases, shard_checks


def chunked_backward_mags(q, k, v, o, lse, do, rows: int = 1024):
    """``backward_mags`` for a causal call (Tq == Tk), a block of query rows
    at a time: the scores of 8,192 tokens at once would take ~9 GB a tensor."""
    import torch

    import merv_tpu_torch.ops.attention as A

    B, H, S, D = q.shape
    Hk = k.shape[1]
    kr, vr = (t.float() for t in A._repeat_kv(k, v, H))
    scale = D ** -0.5
    mq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    mk = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    mv = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    ki = torch.arange(S, device=q.device)[None, :]
    for r0 in range(0, S, rows):
        sl = slice(r0, r0 + rows)
        qs, dos, os_ = q[:, :, sl].float(), do[:, :, sl].float(), o[:, :, sl].float()
        s = torch.matmul(qs, kr.transpose(-1, -2)) * scale
        vis = ki <= torch.arange(r0, r0 + qs.shape[2], device=q.device)[:, None]
        p = torch.where(vis, torch.exp(s - lse[:, :, sl].float()[..., None]), torch.zeros_like(s))
        del s
        ds = (p * (torch.matmul(dos, vr.transpose(-1, -2)) - (dos * os_).sum(-1, keepdim=True))).abs()
        mq[:, :, sl] = torch.matmul(ds, kr.abs()) * scale
        mk += torch.matmul(ds.transpose(-1, -2), qs.abs()) * scale
        mv += torch.matmul(p.transpose(-1, -2), dos.abs())
        del p, ds
    if Hk != H:
        mk, mv = (m.view(B, Hk, H // Hk, S, D).sum(2) for m in (mk, mv))
    return mq, mk, mv


def sp_ring_cases(dev, seed: int) -> list:
    """Phase 4i(b): the ring forward and backward over 2 and 4 in-process
    ranks, natural and zigzag, causal, at Llama-2-7B's and Llama-3.1-8B's
    (GQA 32 -> 8) widths over 8,192 tokens: the output and dq, dk, dv held
    (``hold``) against K2 and K3 on the whole sequence, and the K2 / K3
    launches against the block decomposition (``ring_block_count``)."""
    import gc

    import numpy as np
    import torch

    import merv_tpu_torch.ops.attention as A
    import merv_tpu_torch.ops.ring_attention as R
    from merv_tpu_torch.parallel import VirtualMesh

    rng = np.random.default_rng(seed + 43)
    rows = []
    S = SP_RING_SEQ
    for label, H, Hk in SP_RING_SHAPES:
        q = _randn(rng, (1, H, S, 128), dev)
        k, v = (_randn(rng, (1, Hk, S, 128), dev) for _ in range(2))
        do = _randn(rng, (1, H, S, 128), dev)
        o_ref, lse_ref = A.flash_attention_forward(q, k, v, causal=True, return_lse=True)
        grads_ref = A.flash_attention_backward(q, k, v, o_ref, lse_ref, do, causal=True)
        o_mag = A.flash_attention_forward(q, k, v.abs(), causal=True)
        g_mags = chunked_backward_mags(q, k, v, o_ref, lse_ref, do)
        whole_ms = time_ms(lambda: A.flash_attention_forward(q, k, v, causal=True), 5)
        for n in SP_RING_RANKS:
            for zigzag in (False, True):
                perm = torch.as_tensor(R.zigzag_perm(S, n), device=dev) if zigzag else None
                inv = torch.argsort(perm) if zigzag else None
                lay = (lambda t: t[:, :, perm].contiguous()) if zigzag else (lambda t: t)  # noqa: E731
                unlay = (lambda t: t[:, :, inv]) if zigzag else (lambda t: t)  # noqa: E731
                leaves = tuple(lay(t).detach().requires_grad_() for t in (q, k, v))
                mesh = VirtualMesh(n)
                before = A.launch_counts()
                out = R.ring_attention(*leaves, mesh, causal=True, zigzag=zigzag)
                torch.cuda.synchronize()
                fwd = A.launches_since(before).get("flash_attention_forward", 0)
                before = A.launch_counts()
                out.backward(lay(do))
                torch.cuda.synchronize()
                bwd = A.launches_since(before).get("flash_attention_backward", 0)
                held = {"out": hold(unlay(out.detach()), o_ref, o_mag)}
                for gname, leaf, ref, mag in zip(("dq", "dk", "dv"), leaves, grads_ref, g_mags):
                    held[gname] = hold(unlay(leaf.grad), ref, mag)
                predicted = R.ring_block_count(n, True, zigzag)
                with torch.no_grad():
                    xs = tuple(x.detach() for x in leaves)
                    ring_ms = time_ms(lambda: R.ring_attention(*xs, mesh, causal=True, zigzag=zigzag), 3)
                row = dict(shape=label, heads=[H, Hk], seq=S, ranks=n, zigzag=zigzag, k2_launches=fwd,
                           k3_launches=bwd, predicted=predicted,
                           held={key: {kk: h[kk] for kk in ("worst_share_of_limit", "max_abs_err", "mean_share", "ok")}
                                 for key, h in held.items()},
                           ring_forward_ms_all_ranks=ring_ms, whole_k2_ms=whole_ms)
                rows.append(row)
                log(f"[sp] ring {label} [1, {H}->{Hk}, {S}, 128] over {n} in-process ranks "
                    f"{'zigzag' if zigzag else 'natural'}: K2 {fwd} / K3 {bwd} launches (blocks {predicted}); "
                    f"worst/limit out {held['out']['worst_share_of_limit']:.3f} dq {held['dq']['worst_share_of_limit']:.3f}"
                    f" dk {held['dk']['worst_share_of_limit']:.3f} dv {held['dv']['worst_share_of_limit']:.3f}; "
                    f"forward of all ranks in turn {ring_ms:.3f} ms, K2 on the whole sequence {whole_ms:.3f} ms")
                if fwd != predicted or bwd != predicted:
                    raise RuntimeError(f"ring {label} n={n} zigzag={zigzag}: K2 {fwd} / K3 {bwd} launches, "
                                       f"predicted {predicted}")
                if not all(h["ok"] for h in held.values()):
                    raise RuntimeError(f"ring {label} n={n} zigzag={zigzag}: outside the limits against K2 / K3 "
                                       f"on the whole sequence: {row['held']}")
                del leaves, out
        del q, k, v, do, o_ref, lse_ref, grads_ref, o_mag, g_mags
        gc.collect()
        torch.cuda.empty_cache()
    return rows


class SpRecorder:
    """Wraps, for one eval run, what phase 4i(c) reads: the first prefill's
    logits, every KV cache made (rows, sharded or not, bytes), the decode
    runners' and the engine chunks' modes (graph or eager), the generated
    tokens (the group path's, and the engine's by request), the first decode's
    logits step by step, the inputs and outputs of the run's first K5 call
    with its LSE, and a model load kept for the process's later runs."""

    def __init__(self):
        self.model = None
        self.reset()

    def reset(self):
        self.logits, self.caches, self.modes, self.tokens = None, [], set(), []
        self.engine_tokens, self.step_logits, self.loads, self.k5_first = {}, [], 0, None

    @contextlib.contextmanager
    def active(self):
        import torch

        import merv_tpu_torch.cli.eval_mcq as port_mcq
        import merv_tpu_torch.models.generation as G
        import merv_tpu_torch.models.vidlms.merv as M
        import merv_tpu_torch.ops.decode_attention as K5
        import merv_tpu_torch.serving.engine as E
        from merv_tpu_torch.models.backbones.llm.transformer import KVCache

        rec = self
        create, load, prefill, runner, run = KVCache.create.__func__, port_mcq.load_vid, G.prefill, G.decode_runner, \
            E._Chunk.run
        generate, engine_run, k5 = M._generate, E.ContinuousBatchingEngine.run, K5.decode_attention
        step, replay, load_state = G.DecodeRunner.step, G.DecodeRunner.replay, G.DecodeRunner.load

        def capturing(t):
            return t.is_cuda and torch.cuda.is_current_stream_capturing()

        def created(cls, *a, **kw):
            c = create(cls, *a, **kw)
            rec.caches.append(dict(rows=c.k.shape[3], positions=c.max_len, sharded=c.sp is not None,
                                   bytes=sum(t.numel() * t.element_size()
                                             for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None)))
            return c

        def loaded(*a, **kw):
            if rec.model is None:
                rec.model = load(*a, **kw)
            return rec.model

        def prefilled(*a, **kw):
            out = prefill(*a, **kw)
            if rec.logits is None:
                rec.logits = out[0].float().cpu()
            return out

        def made_runner(*a, **kw):
            r, made = runner(*a, **kw)
            rec.modes.add(f"decode:{r.mode}")
            return r, made

        def chunk_run(chunk, engine):
            rec.modes.add(f"engine:{'graph' if chunk.graph is not None else 'eager'}")
            return run(chunk, engine)

        def generated(*a, **kw):
            out = generate(*a, **kw)
            rec.tokens.extend(out.tolist())
            return out

        def engine_ran(engine, *a, **kw):
            out = engine_run(engine, *a, **kw)
            rec.engine_tokens.update({rid: r.token_ids.tolist() for rid, r in out.items()})
            return out

        def state_loaded(r, *a, **kw):  # the first decode's steps are kept (a warm-up step precedes every load)
            load_state(r, *a, **kw)
            rec.loads += 1

        def stepped(r, decoder):
            out = step(r, decoder)
            if rec.loads == 1 and not capturing(out):
                rec.step_logits.append(out.clone())
            return out

        def replayed(r):
            out = replay(r)
            if rec.loads == 1:
                rec.step_logits.append(out.clone())
            return out

        def k5_called(q, k, v, k_scale=None, v_scale=None, **kw):
            out = k5(q, k, v, k_scale, v_scale, **kw)
            if kw.get("return_lse") and rec.k5_first is None and not capturing(q):
                keep = lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t  # noqa: E731
                rec.k5_first = dict(args=tuple(keep(t) for t in (q, k, v, k_scale, v_scale)),
                                    kw={key: keep(val) for key, val in kw.items() if key != "return_lse"},
                                    out=tuple(keep(t) for t in out))
            return out

        with patched((KVCache, "create", classmethod(created)), (port_mcq, "load_vid", loaded), (G, "prefill", prefilled),
                     (E, "prefill", prefilled), (G, "decode_runner", made_runner), (E._Chunk, "run", chunk_run),
                     (M, "_generate", generated), (E.ContinuousBatchingEngine, "run", engine_ran),
                     (G.DecodeRunner, "load", state_loaded), (G.DecodeRunner, "step", stepped),
                     (G.DecodeRunner, "replay", replayed), (K5, "decode_attention", k5_called)):
            yield

    def path_hold(self):
        """The run's first K5 call with its LSE held against the plain version
        on its own inputs (``k5_lse_hold``), after the run: None if there was none."""
        if self.k5_first is None:
            return None
        c = self.k5_first
        q, k = c["args"][:2]
        off = c["kw"].get("q_offset")
        h = k5_lse_hold(*c["args"], c["kw"], *c["out"])
        return dict(q=list(q.shape), cache=list(k.shape), dtype=str(k.dtype).replace("torch.", ""),
                    causal=bool(c["kw"].get("causal")), q_offset=None if off is None else
                    off.tolist() if hasattr(off, "tolist") else off, ok=h["ok"], finite=h["finite"],
                    out={key: h["out"][key] for key in ("worst_share_of_limit", "mean_share", "max_abs_err")},
                    lse={key: h["lse"][key] for key in ("worst_share_of_limit", "empty_rows", "same_empty_rows")})


def sp_eval_run(label: str, extra: list, root: str, rec: SpRecorder) -> dict:
    """One ``eval_openended`` run on runs/<SP_RUN> through ``evaluate(args=...)``
    (on this rank), instrumented by ``rec``: wall, launches, collectives,
    peak memory, caches, modes, tokens, the first decode's logits step by
    step; after the counts are read, the run's first K5 call with its LSE
    held against the plain version."""
    import torch

    import merv_tpu_torch.ops.attention as A
    import merv_tpu_torch.ops.ring_attention as R
    from merv_tpu_torch.cli import eval_openended
    from merv_tpu_torch.parallel.mesh import world

    if world()[0] == 0 and "WORLD_SIZE" not in os.environ:  # the ranks' roots are cleared before they start
        shutil.rmtree(os.path.join(root, SP_RUN), ignore_errors=True)
    argv = ["--model_path", SP_RUN, "--eval_dataset", SP_EVAL_DATASET, "--max_new_tokens", str(SP_EVAL_MAX_NEW),
            "--allow_random_weights", "true", "--skip_flops", "true", "--eval_result_root", root] + extra
    rec.reset()
    A.reset_launch_counts()
    R.reset_collective_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with rec.active(), contextlib.redirect_stdout(io.StringIO()):
        eval_openended.evaluate(args=argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: n for k, n in A.launch_counts().items() if n}
    collectives = dict(R.COLLECTIVES)
    big = max(rec.caches, key=lambda c: c["bytes"])
    steps = torch.stack(rec.step_logits).cpu() if rec.step_logits else None
    return dict(label=label, argv=argv, wall_s=wall, launches=launches, collectives=collectives,
                peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30, decode_cache=big, caches=rec.caches,
                modes=sorted(rec.modes), tokens=rec.tokens, engine_tokens=rec.engine_tokens,
                k5_lse_path_hold=rec.path_hold(), logits=rec.logits, step_logits=steps)


def sp_worker(out_dir: str, seed: int) -> int:
    """One rank of phase 4i(c) and then of 4j, started by ``torch.distributed.run``
    (``--sp-worker``): both eval runs at --mesh_seq 2 over gloo on the one
    card, results to ``out_dir``; then, in the same world, 4j's tensor = 2
    serving (``tensor_worker``)."""
    import gc

    import torch

    from merv_tpu_torch.parallel.mesh import world

    rank = world()[0]
    rec = SpRecorder()
    out = {}
    for label, extra in SP_EVAL_RUNS:
        r = sp_eval_run(label, extra + ["--mesh_seq", str(SP_RANKS), "--dist_backend", "gloo"],
                        os.path.join("eval_result", f"sp_{label}"), rec)
        logits = dict(first=r.pop("logits"), steps=r.pop("step_logits"))
        if rank == 0:
            torch.save(logits, os.path.join(out_dir, f"logits_{label}.pt"))
        out[label] = r
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    tensor_worker(seed)
    return 0


def first_divergence(a, b):
    """The first index at which two token lists differ (None if they agree over the shorter)."""
    return next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)


def stepwise_logits(tok, ref_tok, first, ref_first, steps, ref_steps, tol: float = LOGITS_REL_TOL) -> dict:
    """Two greedy decodes of the same batch, ``tok`` against ``ref_tok``
    [rows][tokens] (token 0 from the prefill's logits ``first`` [rows, V],
    token t >= 1 from ``steps[t - 1]`` [rows, V]), row by row: the first
    token that differs; the relative L2 of the logits at every step up to and
    including that one (their inputs are still equal), over the entries
    finite in both (the EOS ban's -inf must sit on the same entries); and at
    that step the reference's margin between its token and the other's
    against how far the logits of those two tokens moved. ``ok``: every
    step within ``tol``, and the same entries non-finite."""
    import torch

    rows, worst, agree, total = [], 0.0, 0, 0
    for i, (ta, tb) in enumerate(zip(tok, ref_tok)):
        d = first_divergence(ta, tb)
        n = min(len(ta), len(tb))
        agree, total = agree + sum(x == y for x, y in zip(ta, tb)), total + n
        last = min(n - 1 if d is None else d, len(steps), len(ref_steps))
        pick = lambda f, st, t: (f[i] if t == 0 else st[t - 1][i]).float()  # noqa: E731
        rels, same_inf = [], True
        for t in range(last + 1):
            la, lb = pick(first, steps, t), pick(ref_first, ref_steps, t)
            fin = torch.isfinite(la) & torch.isfinite(lb)
            same_inf &= bool(torch.equal(torch.isfinite(la), torch.isfinite(lb)))
            rels.append(rel_l2(la[fin], lb[fin]))
        row = dict(first_divergent_token=d, steps_compared=len(rels), logits_rel_l2_max=max(rels),
                   same_non_finite=same_inf)
        if d is not None and d <= last:
            la, lb = pick(first, steps, d), pick(ref_first, ref_steps, d)
            row.update(ref_margin=(lb[tb[d]] - lb[ta[d]]).item(),
                       logits_moved=(la - lb)[[ta[d], tb[d]]].abs().max().item())
        worst = max(worst, row["logits_rel_l2_max"])
        rows.append(row)
    return dict(rows=rows, logits_rel_l2_max=worst, ok=worst <= tol and all(r["same_non_finite"] for r in rows),
                greedy_token_agreement=agree / total if total else None)


def sp_entry_path(dev, seed: int, ranks_started, beside=None) -> dict:
    """Phase 4i(c), second half: ``eval_openended`` at sp = 1 here (group
    path, then ``--use_engine``; one load for both) while the ranks run, then
    the ranks' results. Fails unless each rank's counts show the sharded route
    (K5 with its LSE, no unsharded K5 launch, a sharded decode cache of about
    half the sp = 1 bytes), each rank's first K5 call with its LSE holds
    against the plain version on its own inputs, the first-token logits agree
    with sp = 1's and, on the group path, every decode step's logits agree
    with sp = 1's up to the first token that differs. ``beside``: called once
    the sp = 1 runs are done and their model freed, while the ranks run (4j's
    world-1 reference); what it returns is ``result["beside"]``."""
    import gc

    import torch

    proc, logf, t_ranks = ranks_started
    out_dir = os.path.join("chiprun_out", "sp")
    t0 = time.perf_counter()
    try:
        rec = SpRecorder()
        sp1 = {label: sp_eval_run(label, extra, os.path.join("eval_result", f"sp1_{label}"), rec)
               for label, extra in SP_EVAL_RUNS}
        del rec
        gc.collect()
        torch.cuda.empty_cache()
        beside_out = None if beside is None else beside()
        rc = proc.wait(timeout=SP_WORKER_TIMEOUT_S)
        ranks_wall = time.perf_counter() - t_ranks
        logf.close()
        if rc != 0:
            tail = open(os.path.join(out_dir, "ranks.log")).read()[-3000:]
            raise RuntimeError(f"sp ranks failed (rc {rc}): {tail}")
        ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(SP_RANKS)]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()
        shutil.rmtree(os.path.join("runs", SP_RUN), ignore_errors=True)
        for label, _ in SP_EVAL_RUNS:
            for prefix in ("sp1", "sp"):
                shutil.rmtree(os.path.join("eval_result", f"{prefix}_{label}"), ignore_errors=True)
    result = dict(ranks_process_wall_s=ranks_wall, runs={}, beside=beside_out)
    for label, _ in SP_EVAL_RUNS:
        base = sp1[label]
        got = torch.load(os.path.join(out_dir, f"logits_{label}.pt"))
        rel = rel_l2(got["first"], base["logits"])
        per_rank = []
        for r, rk in enumerate(ranks):
            x = rk[label]
            ratio = x["decode_cache"]["bytes"] / base["decode_cache"]["bytes"]
            per_rank.append(dict(rank=r, wall_s=x["wall_s"], peak_memory_gib=x["peak_memory_gib"],
                                 decode_cache=x["decode_cache"], cache_bytes_ratio=ratio, launches=x["launches"],
                                 collectives=x["collectives"], modes=x["modes"],
                                 k5_lse_path_hold=x["k5_lse_path_hold"]))
            log(f"[sp] {label} rank {r}: wall {x['wall_s']:.2f} s, peak {x['peak_memory_gib']:.2f} GiB, decode cache "
                f"{x['decode_cache']} ({ratio:.4f} of sp = 1's {base['decode_cache']['bytes']} bytes), launches "
                f"{x['launches']}, collectives {x['collectives']}, modes {x['modes']}; the first K5 call with its LSE "
                f"held against the plain version on its inputs: {x['k5_lse_path_hold']}")
            if not x["decode_cache"]["sharded"] or x["launches"].get("decode_attention", 0) \
                    or not x["launches"].get("decode_attention_lse", 0) or not 0.45 <= ratio <= 0.51:
                raise RuntimeError(f"sp {label} rank {r}: the counts do not show the sharded route: {per_rank[-1]}")
            if not (x["k5_lse_path_hold"] or {}).get("ok"):
                raise RuntimeError(f"sp {label} rank {r}: the path's K5 call with its LSE is outside its limits "
                                   f"against the plain version: {x['k5_lse_path_hold']}")
        run = dict(sp1=dict(wall_s=base["wall_s"], peak_memory_gib=base["peak_memory_gib"],
                            decode_cache=base["decode_cache"], launches=base["launches"], modes=base["modes"]),
                   ranks=per_rank, first_token_logits_rel_l2=rel)
        if base["tokens"]:  # the group path: its decode's logits step by step
            run["stepwise"] = stepwise_logits(ranks[0][label]["tokens"], base["tokens"], got["first"], base["logits"],
                                              got["steps"], base["step_logits"])
            agreement = run["stepwise"]["greedy_token_agreement"]
        else:  # the engine: its tokens by request
            pairs = [(ranks[0][label]["engine_tokens"].get(rid), t) for rid, t in base["engine_tokens"].items()]
            same = [a == b for x, y in pairs if x is not None for a, b in zip(x, y)]
            agreement = sum(same) / len(same) if same else None
            run["first_divergent_token"] = {rid: first_divergence(ranks[0][label]["engine_tokens"].get(rid, []), t)
                                            for rid, t in base["engine_tokens"].items()}
        run["greedy_token_agreement"] = agreement
        result["runs"][label] = run
        log(f"[sp] {label}: sp = 2 against sp = 1: first-token logits rel L2 {rel:.3e} (tol {LOGITS_REL_TOL}), "
            f"greedy-token agreement {agreement}; " + (
                "by row: " + "; ".join(
                    f"first differing token {'none' if r['first_divergent_token'] is None else r['first_divergent_token']}"
                    f", logits rel L2 <= {r['logits_rel_l2_max']:.3e} over the {r['steps_compared']} steps up to it"
                    + (f", at the first differing token sp = 1's margin {r['ref_margin']:.4f} against a move of "
                       f"{r['logits_moved']:.4f}" if "ref_margin" in r else "")
                    for r in run["stepwise"]["rows"]) if "stepwise" in run else
                f"first differing token by request {run['first_divergent_token']}")
            + f"; sp = 1 wall {base['wall_s']:.2f} s, modes {base['modes']} (both read beside the ranks' run)")
        if not rel <= LOGITS_REL_TOL:
            raise RuntimeError(f"sp {label}: first-token logits differ from sp = 1's by {rel}")
        if "stepwise" in run and not run["stepwise"]["ok"]:
            raise RuntimeError(f"sp {label}: decode logits differ from sp = 1's before the tokens do: {run['stepwise']}")
    result["wall_s"] = time.perf_counter() - t0
    return result


def sp_path(dev, seed: int) -> dict:
    """Phase 4i: (a) K5 with its LSE on cache shards, on the card alone (its
    timings); then the ranks of (c) start, and (b) the ring on 8,192 tokens and
    (c)'s sp = 1 reference run beside them (their times are read under the
    ranks' load); last the ranks' results."""
    import gc

    import torch

    t = time.perf_counter()
    k5_cases, shard_checks = sp_k5_cases(dev, seed)
    gc.collect()
    torch.cuda.empty_cache()
    started = tensor_start_ranks(dev, seed, sp=True)
    try:
        ring = sp_ring_cases(dev, seed)
    except BaseException:
        started[0].kill()
        started[0].wait()
        raise
    # the ring's own launches (its blocks, forward and backward), not the whole-sequence comparisons beside them
    ring_launches = {"flash_attention_forward": sum(r["k2_launches"] for r in ring),
                     "flash_attention_backward": sum(r["k3_launches"] for r in ring)}
    entry = sp_entry_path(dev, seed, started, beside=lambda: tensor_reference(dev, seed))
    tensor = tensor_checks(*entry.pop("beside"))
    tensor["ranks_process_wall_s"] = entry["ranks_process_wall_s"]
    wall = time.perf_counter() - t
    log(f"[sp] phases 4i and 4j: {wall:.1f} s")
    return dict(wall_s=wall, k5_cases=k5_cases, shard_checks=shard_checks, ring=ring, ring_launches=ring_launches,
                entry=entry, tensor=tensor)


# ---------------------------------------------------------------------------
# phase 4j: tensor-parallel serving (two ranks over gloo on the one card, beside a world-1 reference)
# ---------------------------------------------------------------------------

TENSOR_RANKS = 2
TENSOR_OUT = os.path.join("chiprun_out", "tp")  # the ranks' results and logs
TENSOR_QUESTIONS = ("What is happening in this video?", "Describe the scene in one sentence.",
                    "What color is the largest object?")
TENSOR_MAX_NEW = 16  # MERV.generate's tokens
TENSOR_ENGINE_NEW = 8  # each engine request's tokens: one chunk of steps_per_sync steps
TENSOR_ENGINE = dict(slots=3, max_len=1280, length_bucket=64, steps_per_sync=8)  # one slot a question
TENSOR_GAMMAS = (0, 2)
# a rank's LLM weight bytes and decode-cache bytes against world 1's: half (the norms stay whole, 0.0001 of them)
TENSOR_SHARE = (0.49, 0.51)
# logits against world 1's, relative L2: each request's first token and every decode or verify step up to the first
# differing token. The row-split Linears' two bf16 partials, summed, round otherwise than one whole GEMM, and random
# weights carry that through 32 layers (2.900e-2 at the first token). The limit lies between world 1's control, which
# adds the two partials itself, and the planted faults; every run checks both (PERF.md has the readings).
TENSOR_LOGITS_REL_TOL = 1e-1
# world 1's first token with o's and down's GEMMs cut at half their input: the two partials added (the control), the
# first kept (a rank that skipped its sum), each half of the input on the other half of the weight (shards swapped)
TENSOR_SPLIT_RUNS = ("control", "skipped_sum", "swapped_shards")
TENSOR_WORKER_TIMEOUT_S = 600
TENSOR_DEVICE = "cuda"  # the ranks' device type


def tensor_prompts(llm) -> list:
    out = []
    for q in TENSOR_QUESTIONS:
        builder = llm.prompt_builder_fn("merv")
        builder.add_turn("human", q)
        out.append(builder.get_prompt())
    return out


def tensor_step_collectives(decoder) -> dict:
    """The tensor collectives of one T = 1 decode step of ``decoder`` (after a 4-token prefill)."""
    import torch

    from merv_tpu_torch.models.backbones.llm.transformer import KVCache
    from merv_tpu_torch.parallel import tensor as TP

    dev = next(decoder.parameters()).device
    cache = KVCache.create(decoder.cfg, 1, 8, decoder.cfg.compute_dtype, dev, tp=decoder.tp)
    with torch.inference_mode():
        _, cache = decoder(input_ids=torch.ones(1, 4, dtype=torch.long, device=dev), kv_cache=cache)
        TP.reset_counts()
        decoder(input_ids=torch.ones(1, 1, dtype=torch.long, device=dev), kv_cache=cache)
    return dict(TP.COUNTS)


class EngineLogits:
    """Wraps one engine run, which it makes run its chunks eagerly (a CUDA
    graph's replay reads nothing back), and keeps the logits behind every
    token it emits: each prefill's rows in admission order (slot i holds
    request i: the requests fill the free slots in order) and each decode or
    verify step's [slots, T, V] beside the tokens the step chose."""

    def __init__(self):
        self.first, self.chunks = [], []

    @contextlib.contextmanager
    def active(self):
        import merv_tpu_torch.serving.engine as E

        rec = self
        prefill, prefill_prefix, plain, spec = E.prefill, E.prefill_with_prefix, E._decode_chunk, E._decode_chunk_spec

        def first_of(fn):
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                rec.first.append(out[0].float().cpu())
                return out
            return wrapped

        def recording(decoder, steps):
            def call(**kw):
                logits, cache = decoder(**kw)
                steps.append(logits.float().cpu())
                return logits, cache
            return call

        def plain_chunk(decoder, st, cfg, num_steps, generator, toks):
            steps = []
            plain(recording(decoder, steps), st, cfg, num_steps, generator, toks)
            rec.chunks.append((steps, toks.cpu()[:, :, None], None))

        def spec_chunk(decoder, st, cfg, num_steps, gamma, ngram, generator, wins, emits):
            steps = []
            spec(recording(decoder, steps), st, cfg, num_steps, gamma, ngram, generator, wins, emits)
            rec.chunks.append((steps, wins.cpu(), emits.cpu()))

        with patched((E, "prefill", first_of(prefill)), (E, "prefill_with_prefix", first_of(prefill_prefix)),
                     (E, "_decode_chunk", plain_chunk), (E, "_decode_chunk_spec", spec_chunk),
                     (E._Chunk, "capture", lambda chunk, engine: None)):
            yield

    def by_request(self, tokens: dict, eos: int) -> dict:
        """(first [rows, V], steps [T, rows, V], tokens [rows][...]): row i is
        request i's (``tokens``: the engine's results by request id "i", cut
        after the first ``eos``), steps[t - 1][i] the logits that chose its
        token t. Fails unless the tokens the recorded steps chose are the
        results'."""
        import torch

        rows = len(tokens)
        first = torch.cat(self.first)[:rows]
        chosen, logits = [[] for _ in range(rows)], [[] for _ in range(rows)]
        for steps, toks, emits in self.chunks:
            for i, lg in enumerate(steps):
                for b in range(rows):
                    n = 1 if emits is None else int(emits[i, b])
                    chosen[b].extend(int(t) for t in toks[i, b, :n])
                    logits[b].extend(lg[b, :n])
        toks = []
        for b in range(rows):
            t = list(tokens[str(b)])
            t = t[: t.index(eos) + 1] if eos in t else t
            t = t[: len(chosen[b]) + 1]
            if t[1:] != chosen[b][: len(t) - 1]:
                raise RuntimeError(f"engine request {b}: the recorded steps chose {chosen[b]}, the engine returned "
                                   f"{tokens[str(b)]}")
            toks.append(t)
        T = max(len(t) for t in toks) - 1
        V = first.shape[-1]
        steps = torch.stack([torch.stack([logits[b][t] if t < len(logits[b]) else torch.zeros(V)
                                          for b in range(rows)]) for t in range(T)]) if T > 0 else torch.zeros(0, rows, V)
        return dict(first=first, steps=steps, tokens=toks)


def tensor_engine_run(vidlm, cfg, video, mesh, gamma: int, prefix: bool, int8: bool) -> tuple:
    """One engine run of the three questions on ``video`` (or on its shared
    prefix), eager (``EngineLogits``): (its launches against
    ``engine_predicted_launches`` of its own counts (unpacked Linears), its
    tokens (rank 0's), wall and slot cache; its logits by request, rank 0's)."""
    import torch

    import merv_tpu_torch.ops.attention as A
    from merv_tpu_torch.models.generation import GenerationConfig
    from merv_tpu_torch.serving import ContinuousBatchingEngine, Request

    llm = vidlm.llm_backbone
    gcfg = GenerationConfig(max_new_tokens=TENSOR_ENGINE_NEW, eos_token_id=llm.stop_token_id,
                            pad_token_id=llm.pad_token_id)
    engine = ContinuousBatchingEngine.for_vidlm(vidlm, config=gcfg, speculative_gamma=gamma, mesh=mesh,
                                                **TENSOR_ENGINE)
    rec = EngineLogits()
    torch.cuda.synchronize()
    A.reset_launch_counts()
    t = time.perf_counter()
    with rec.active():
        if prefix:
            engine.register_prefix_video("demo", video, num_frames=cfg.num_frames)
        out = engine.run([Request(str(i), prompt_text=p, video=None if prefix else video,
                                  max_new_tokens=TENSOR_ENGINE_NEW, prefix_id="demo" if prefix else None)
                          for i, p in enumerate(tensor_prompts(llm))])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    s = engine.stats
    summary = dict(prefills=s.prefills, suffix_prefills=s.suffix_prefills, prefix_builds=int(prefix),
                   prefill_shapes=list(s.prefill_shapes), decode_forwards=s.decode_forwards,
                   prefix_rows=list(s.prefix_rows))
    counts = A.launch_counts()
    predicted = engine_predicted_launches(summary, quantized=int8, layers=llm.decoder.cfg.num_layers,
                                          linears=UNPACKED_LINEARS)
    wrong = {k: (counts.get(k, 0), n) for k, n in predicted.items() if counts.get(k, 0) != n}
    tokens = {rid: r.token_ids.tolist() for rid, r in out.items()}
    return (dict(tokens=tokens, wall_s=wall, summary=summary, launches={k: n for k, n in counts.items() if n},
                 predicted_launches=predicted, wrong_launches=wrong, slot_cache=list(engine._state.k.shape),
                 modes=sorted({"graph" if c.graph is not None else "eager" for c in engine._chunks.values()})),
            rec.by_request(tokens, llm.stop_token_id) if tokens else None)


def tensor_split_runs(vidlm, cfg, video, prompt) -> dict:
    """World 1's first-token logits of ``MERV.generate`` on ``prompt`` for
    each of ``TENSOR_SPLIT_RUNS``: every layer's o_proj and down_proj (bf16
    GEMMs) computed from the halves of their input, as the tensor = 2 ranks
    hold them, and the halves combined as the run's name says."""
    import torch.nn.functional as F

    def split(kind):
        def hook(mod, args, out):
            x = args[0]
            w = mod.weight.to(x.dtype)
            h = x.shape[-1] // 2
            lo, hi = x[..., :h], x[..., h:]
            if kind == "control":
                return F.linear(lo, w[:, :h]) + F.linear(hi, w[:, h:])
            if kind == "skipped_sum":
                return F.linear(lo, w[:, :h])
            return F.linear(hi, w[:, :h]) + F.linear(lo, w[:, h:])
        return hook

    out = {}
    for kind in TENSOR_SPLIT_RUNS:
        handles = [m.register_forward_hook(split(kind)) for layer in vidlm.llm_backbone.decoder.layers
                   for m in (layer.attn.o_proj, layer.mlp.down_proj)]
        rec = SpRecorder()
        try:
            with rec.active():
                vidlm.generate(video, prompt, num_frames=cfg.num_frames, max_new_tokens=1)
        finally:
            for h in handles:
                h.remove()
        out[kind] = rec.logits
    return out


def tensor_serving(vidlm, cfg, video, mesh) -> tuple:
    """Phase 4j's serving on one model (a rank's shards, or world 1's whole
    unpacked weights): ``MERV.generate`` with its launches, its tensor
    collectives, its first-token logits and decode logits step by step
    (``SpRecorder``), one decode step's collectives, the LLM's weight bytes
    and the decode cache's; at world 1, ``tensor_split_runs``; then the engine
    at each of ``TENSOR_GAMMAS``. Returns (results, logits)."""
    import torch

    import merv_tpu_torch.ops.attention as A
    from merv_tpu_torch.parallel import tensor as TP

    llm = vidlm.llm_backbone
    dec = llm.decoder
    L = dec.cfg.num_layers
    prompt = tensor_prompts(llm)[0]
    rec = SpRecorder()
    torch.cuda.synchronize()
    A.reset_launch_counts()
    TP.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t = time.perf_counter()
    with rec.active():
        vidlm.generate(video, prompt, num_frames=cfg.num_frames, max_new_tokens=TENSOR_MAX_NEW, mesh=mesh,
                       timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = A.launch_counts()
    collectives = dict(TP.COUNTS)
    steps = timings["decode_steps"] + (2 if timings["decode_capture_s"] > 0 else 0)
    predicted = request_launches(L, steps)
    request = dict(
        wall_s=wall, prefill_s=timings["prefill_s"], decode_s=timings["decode_s"], decode_steps=timings["decode_steps"],
        decode_capture_s=timings["decode_capture_s"], tokens=rec.tokens, modes=sorted(rec.modes),
        launches={k: n for k, n in counts.items() if n}, predicted_launches=predicted,
        wrong_launches={k: (counts.get(k, 0), n) for k, n in predicted.items() if counts.get(k, 0) != n},
        collectives=collectives, peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        decode_cache_bytes=max(c["bytes"] for c in rec.caches))
    logits = dict(first=rec.logits, steps=torch.stack(rec.step_logits).cpu() if rec.step_logits else None,
                  split=None if mesh is not None else tensor_split_runs(vidlm, cfg, video, prompt), engine={})
    out = dict(request=request, step_collectives=tensor_step_collectives(dec), layers=L,
               llm_weight_bytes=sum(t.numel() * t.element_size() for t in list(dec.parameters()) + list(dec.buffers())),
               packed="qkv_proj" in dec.layers[0].attn._modules,
               tp=None if dec.tp is None else dict(n=dec.tp.n, rank=dec.tp.rank, num_heads=dec.tp.num_heads,
                                                   kv_heads=dec.tp.kv_heads, vocab_range=list(dec.tp.vocab_range)),
               engine={})
    for g in TENSOR_GAMMAS:
        out["engine"][f"gamma{g}"], logits["engine"][f"gamma{g}"] = tensor_engine_run(vidlm, cfg, video, mesh, g,
                                                                                      False, False)
    return out, logits


def tensor_models(mesh, run_dir: str, seed: int) -> tuple:
    """(bf16 results, int8 results, logits): phase 4j on ``run_dir`` loaded
    by ``load_vid`` on ``mesh`` (the rank's Megatron shards; None: world 1
    with the unpacked layout the ranks take), then again with
    ``quantize_llm=True`` through the engine on a shared prefix (the demo
    video's, registered once)."""
    import gc

    import torch

    from merv_tpu_torch import load_vid

    video = demo_video(seed)[0]
    t = time.perf_counter()
    vidlm, cfg = load_vid(run_dir, get_model_cfg=True, allow_random_weights=True, pack_llm=False, mesh=mesh)
    load_s = time.perf_counter() - t
    bf16, logits = tensor_serving(vidlm, cfg, video, mesh)
    bf16["load_s"] = load_s
    del vidlm
    gc.collect()
    torch.cuda.empty_cache()
    vidlm, cfg = load_vid(run_dir, get_model_cfg=True, allow_random_weights=True, pack_llm=False,
                          quantize_llm=True, mesh=mesh)
    dec = vidlm.llm_backbone.decoder
    engine, logits["engine"]["int8_prefix"] = tensor_engine_run(vidlm, cfg, video, mesh, 0, True, True)
    int8 = dict(engine=engine,
                llm_weight_bytes=sum(t.numel() * t.element_size() for t in list(dec.parameters()) + list(dec.buffers())))
    del vidlm, dec
    gc.collect()
    torch.cuda.empty_cache()
    return bf16, int8, logits


def tensor_worker(seed: int) -> None:
    """Phase 4j on one rank (started by ``torch.distributed.run``, after 4i's
    runs in the same world, or alone under ``--tp-worker``): the tensor = 2
    mesh over gloo, results to ``TENSOR_OUT``."""
    import torch

    from merv_tpu_torch.parallel import MeshConfig, build_mesh
    from merv_tpu_torch.parallel.mesh import world

    rank = world()[0]
    mesh = build_mesh(MeshConfig(data=1, fsdp=1, tensor=TENSOR_RANKS), device_type=TENSOR_DEVICE, backend="gloo")
    t = time.perf_counter()
    bf16, int8, logits = tensor_models(mesh, os.path.join("runs", SP_RUN), seed)
    if rank == 0:
        torch.save(logits, os.path.join(TENSOR_OUT, "logits.pt"))
    with open(os.path.join(TENSOR_OUT, f"rank{rank}.json"), "w") as f:
        json.dump(dict(bf16=bf16, int8=int8, wall_s=time.perf_counter() - t), f, default=str)


def agreement_by_request(a: dict, b: dict):
    """The share of equal tokens over the requests both hold, and each request's first differing token."""
    same = [x == y for rid in b if rid in a for x, y in zip(a[rid], b[rid])]
    return (sum(same) / len(same) if same else None), {rid: first_divergence(a.get(rid, []), b[rid]) for rid in b}


def tensor_checks(ref: dict, ref_logits: dict) -> dict:
    """The ranks' results against world 1's: fails unless each rank holds
    ``TENSOR_SHARE`` of world 1's LLM weight bytes (bf16 and int8) and decode
    cache bytes, one decode step makes 2 L + 1 sums and 1 gather, every run's
    launches are its counts' prediction (world 1's request adds its graph
    capture's warm-up steps to its own), world 1's split control reads below
    TENSOR_LOGITS_REL_TOL and each planted fault above it, and in every run
    (the request, each engine run, the int8 engine against world 1's) each
    request's first-token logits and every step's up to its first differing
    token are within TENSOR_LOGITS_REL_TOL of world 1's. Token agreements
    (random weights: near ties) are reported. The ranks' logits file is
    deleted once read."""
    import torch

    ranks = [json.load(open(os.path.join(TENSOR_OUT, f"rank{r}.json"))) for r in range(TENSOR_RANKS)]
    path = os.path.join(TENSOR_OUT, "logits.pt")
    got = torch.load(path)
    os.remove(path)
    L = ref["bf16"]["layers"]
    tol = TENSOR_LOGITS_REL_TOL
    bad, per_rank = {}, []
    for r, x in enumerate(ranks):
        b = x["bf16"]
        row = dict(rank=r, tp=b["tp"], packed=b["packed"], load_s=b["load_s"],
                   weight_share=b["llm_weight_bytes"] / ref["bf16"]["llm_weight_bytes"],
                   int8_weight_share=x["int8"]["llm_weight_bytes"] / ref["int8"]["llm_weight_bytes"],
                   cache_share=b["request"]["decode_cache_bytes"] / ref["bf16"]["request"]["decode_cache_bytes"],
                   step_collectives=b["step_collectives"], request_collectives=b["request"]["collectives"],
                   request=b["request"], engine=b["engine"], int8_engine=x["int8"]["engine"], wall_s=x["wall_s"])
        per_rank.append(row)
        lo, hi = TENSOR_SHARE
        for key in ("weight_share", "int8_weight_share", "cache_share"):
            if not lo <= row[key] <= hi:
                bad[f"rank{r}/{key}"] = row[key]
        if b["step_collectives"] != {"sum": 2 * L + 1, "gather": 1} or b["packed"]:
            bad[f"rank{r}/step_collectives"] = (b["step_collectives"], b["packed"])
        runs = dict(request=b["request"], **{f"engine_{k}": v for k, v in b["engine"].items()},
                    int8_engine=x["int8"]["engine"])
        for name, run in runs.items():
            if run["wrong_launches"]:
                bad[f"rank{r}/{name}/launches"] = run["wrong_launches"]
    w1 = ref["bf16"]
    for name, run in dict(request=w1["request"], **{f"engine_{k}": v for k, v in w1["engine"].items()},
                          int8_engine=ref["int8"]["engine"]).items():
        if run["wrong_launches"]:
            bad[f"world1/{name}/launches"] = run["wrong_launches"]
    # world 1's o and down GEMMs cut at half their input: the control's rounding, and two planted faults
    split = {k: rel_l2(v, ref_logits["first"]) for k, v in ref_logits["split"].items()}
    split["ranks_vs_control"] = rel_l2(got["first"], ref_logits["split"]["control"])
    if not split["control"] < tol < min(split[k] for k in TENSOR_SPLIT_RUNS if k != "control"):
        bad["split_runs"] = split
    rel = rel_l2(got["first"], ref_logits["first"])
    stepwise = stepwise_logits(ranks[0]["bf16"]["request"]["tokens"], w1["request"]["tokens"], got["first"],
                               ref_logits["first"], got["steps"], ref_logits["steps"], tol)
    if not rel <= tol:
        bad["first_token_logits_rel_l2"] = rel
    if not stepwise["ok"]:
        bad["stepwise"] = stepwise
    engine_logits = {}
    for name, b in ref_logits["engine"].items():
        a = got["engine"][name]
        firsts = [rel_l2(a["first"][i], b["first"][i]) for i in range(len(b["tokens"]))]
        steps = stepwise_logits(a["tokens"], b["tokens"], a["first"], b["first"], a["steps"], b["steps"], tol)
        engine_logits[name] = dict(first_token_logits_rel_l2=firsts, stepwise=steps)
        if not max(firsts) <= tol or not steps["ok"]:
            bad[f"engine_{name}/logits"] = engine_logits[name]
    agree = {g: agreement_by_request(ranks[0]["bf16"]["engine"][g]["tokens"], w1["engine"][g]["tokens"])
             for g in w1["engine"]}
    agree["int8_prefix"] = agreement_by_request(ranks[0]["int8"]["engine"]["tokens"], ref["int8"]["engine"]["tokens"])
    if any(run["tokens"] for x in ranks[1:] for run in list(x["bf16"]["engine"].values()) + [x["int8"]["engine"]]):
        bad["rank1_returned_results"] = True
    result = dict(ranks=per_rank, world1=dict(request=w1["request"], engine=w1["engine"], int8_engine=ref["int8"]["engine"],
                                              llm_weight_bytes=w1["llm_weight_bytes"],
                                              int8_llm_weight_bytes=ref["int8"]["llm_weight_bytes"],
                                              step_collectives=w1["step_collectives"], load_s=w1["load_s"]),
                  first_token_logits_rel_l2=rel, stepwise=stepwise, split_runs=split, engine_logits=engine_logits,
                  agreement=agree, request_wall_vs_world1=per_rank[0]["request"]["wall_s"] / w1["request"]["wall_s"],
                  engine_wall_vs_world1={g: per_rank[0]["engine"][g]["wall_s"] / w1["engine"][g]["wall_s"]
                                         for g in w1["engine"]},
                  predicted=dict(sums_per_step=2 * L + 1, gathers_per_step=1, share=TENSOR_SHARE, logits_rel_tol=tol))
    for r in per_rank:
        log(f"[tp] rank {r['rank']} ({r['tp']}): LLM weights {r['weight_share']:.4f} of world 1's bytes (int8 "
            f"{r['int8_weight_share']:.4f}), decode cache {r['cache_share']:.4f}; one decode step's collectives "
            f"{r['step_collectives']} (2 L + 1 = {2 * L + 1} sums, 1 gather predicted); request wall "
            f"{r['request']['wall_s']:.2f} s ({r['request']['modes']}), launches {r['request']['launches']} "
            f"(predicted {r['request']['predicted_launches']}); engine walls "
            f"{ {g: round(e['wall_s'], 2) for g, e in r['engine'].items()} } s, int8 {r['int8_engine']['wall_s']:.2f} s")
    log(f"[tp] world 1: request wall {w1['request']['wall_s']:.2f} s ({w1['request']['modes']}), engine walls "
        f"{ {g: round(e['wall_s'], 2) for g, e in w1['engine'].items()} } s (eager); first-token logits against "
        f"world 1's whole GEMMs, relative L2: o and down cut in halves {split['control']:.3e} (the control; the ranks "
        f"against it {split['ranks_vs_control']:.3e}), a skipped sum {split['skipped_sum']:.3e}, the shards swapped "
        f"{split['swapped_shards']:.3e} (limit {tol}: above the control, below the faults)")
    log(f"[tp] tensor = 2 against world 1 (limit {tol}): request first-token logits {rel:.3e}, decode steps <= "
        f"{stepwise['logits_rel_l2_max']:.3e} up to the first differing token, greedy agreement "
        f"{stepwise['greedy_token_agreement']}; engine runs: " + "; ".join(
            f"{name} first tokens <= {max(e['first_token_logits_rel_l2']):.3e}, steps <= "
            f"{e['stepwise']['logits_rel_l2_max']:.3e}, first differing token by request "
            f"{[row['first_divergent_token'] for row in e['stepwise']['rows']]}, agreement {agree[name][0]}"
            for name, e in engine_logits.items()))
    if bad:
        raise RuntimeError(f"phase 4j (tensor-parallel serving) failed: {bad}")
    return result


def tensor_start_ranks(dev, seed: int, sp: bool):
    """Start the ranks of phase 4j (with ``sp``, 4i's too, in one world:
    ``--sp-worker`` runs 4i's eval runs, then 4j), their output to
    ``chiprun_out/sp/ranks.log`` (with ``sp``) or ``TENSOR_OUT/ranks.log``.
    Writes merv-full's run directory first. Returns (process, log file, start time)."""
    import socket

    write_run_dir(os.path.join("runs", SP_RUN), dev, seed)
    for name in ("MERV_TPU_TOWER_DIR", "MERV_TPU_LLM_DIR"):
        os.environ.pop(name, None)
    shutil.rmtree(TENSOR_OUT, ignore_errors=True)
    os.makedirs(TENSOR_OUT)
    out_dir = os.path.join("chiprun_out", "sp") if sp else TENSOR_OUT
    if sp:
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        for label, _ in SP_EVAL_RUNS:
            shutil.rmtree(os.path.join("eval_result", f"sp_{label}"), ignore_errors=True)
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(TENSOR_RANKS), "--master_addr",
           "localhost", "--master_port", str(port), os.path.abspath(__file__),
           *(["--sp-worker", out_dir] if sp else ["--tp-worker"]), "--seed", str(seed)]
    logf = open(os.path.join(out_dir, "ranks.log"), "w")
    return subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT, text=True), logf, time.perf_counter()


def tensor_reference(dev, seed: int) -> tuple:
    """Phase 4j's world-1 reference in this process (beside the ranks): (results, logits)."""
    bf16, int8, logits = tensor_models(None, os.path.join("runs", SP_RUN), seed)
    return dict(bf16=bf16, int8=int8), logits


def tensor_path(dev, seed: int) -> dict:
    """Phase 4j alone (``--tp-only``): phase 3's cases at its shard shapes,
    then the ranks (``--tp-worker``) beside the world-1 reference, and the
    checks. The run directory and the ranks' files under ``runs/`` are deleted."""
    t = time.perf_counter()
    cases = tensor_kernel_cases(dev, seed)
    proc, logf, t_ranks = tensor_start_ranks(dev, seed, sp=False)
    try:
        ref, ref_logits = tensor_reference(dev, seed)
        rc = proc.wait(timeout=TENSOR_WORKER_TIMEOUT_S)
        logf.close()
        if rc != 0:
            raise RuntimeError(f"tp ranks failed (rc {rc}): {open(os.path.join(TENSOR_OUT, 'ranks.log')).read()[-3000:]}")
        ranks_wall = time.perf_counter() - t_ranks
        checks = tensor_checks(ref, ref_logits)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()
        shutil.rmtree(os.path.join("runs", SP_RUN), ignore_errors=True)
    checks["ranks_process_wall_s"] = ranks_wall
    return dict(cases=cases, checks=checks, wall_s=time.perf_counter() - t)


# ---------------------------------------------------------------------------
# phase 4e: the serving engine (continuous batching, prefix caching, batched speculation)
# ---------------------------------------------------------------------------

SERVE_RUN = "chip_smoke_serve"  # runs/<SERVE_RUN> (the run directory); its request and result files beside it
# a serve process's share of the card: its peak allocation reads 22.65 GiB, but with the caching allocator's default
# segments it reserved 32.8 GiB at its peak (NVIDIA H100 80GB HBM3; PERF.md section 6), so three at once (this
# process holding 0.06 GiB) ran out of the card's 79.2; on expandable segments it reserves little beyond that
SERVE_PROCESS_GIB = 25.5
SERVE_MAX_NEW_TOKENS = 64
SERVE_SLOTS = 4
SERVE_MAX_LEN = 2048  # merv-full's llm_max_length, as eval_openended --use_engine sizes its engine
SERVE_DATASET = os.path.join("eval_data", "dummy_openended_scaled")
SERVE_TEXT_ONLY = ("Write one sentence about the sea.", "Name three colors.", "What is a video?",
                   "Say hello to the user.")
# (label, the serve command's arguments); each run in a fresh process
SERVE_RUNS = (
    ("shared", ["--share_video_prefix", "true"]),
    ("unshared", ["--share_video_prefix", "false"]),
    ("speculative", ["--speculative", "4", "--share_video_prefix", "true"]),
)
# K1 / K2 launches per program of the engine: a full VidLM prefill (a video or a text-only row: the towers run
# either way) or a prefix build runs K1 in 23 DINOv2 + 23 LanguageBind layers and K2 in 12 ViViT + the LLM's
# layers; a suffix-only prefill runs K2 in the LLM's layers. Decode chunks (T=1 and the verify) run K5 (and K4 with
# int8 weights): engine_predicted_launches counts those from the engine's forwards.
TOWER_K1, TOWER_K2 = 46, 12
CHUNK_GAMMAS = (0, 2, 4, 8)  # the plain chunk and the verify chunks the monitor may pick
CHUNK_TIMED_REPLAYS = 5


LLM_LAYERS = 32  # Llama-2-7B: one K5 launch a layer, and K4 one a Linear and the lm_head
# Linears a decoder layer runs: 4 in the packed serving layout (load_vid's default: qkv, o, gate/up, down), 7 unpacked
PACKED_LINEARS, UNPACKED_LINEARS = 4, 7


def engine_launches(layers: int = LLM_LAYERS) -> dict:
    """K1 / K2 / K6 launches of a full VidLM prefill and of a suffix-only prefill."""
    return {"full": {"small_attention_kt": TOWER_K1, "flash_attention_forward": TOWER_K2 + layers,
                     "layer_norm": TOWER_LN},
            "suffix": {"small_attention_kt": 0, "flash_attention_forward": layers, "layer_norm": 0}}


def engine_predicted_launches(summary: dict, quantized: bool = False, layers: int = LLM_LAYERS,
                              linears: int = PACKED_LINEARS, head: int = 1) -> dict:
    """K1 / K2 / K5 (and, with int8 weights, K4) launches a serve run must
    show, from the engine's own counts: the chunks' decoder forwards (replays
    and capture warm-ups, ``decode_forwards``) each launch K5 once a layer and
    K4 once a Linear (``linears`` a layer, and ``head``: 1 for an int8
    lm_head, 0 for a tied one, a bf16 matmul); an LLM prefill of n rows x T
    tokens (``prefill_shapes``) sends its Linears to K4 when n x T <= 64 and
    its lm_head (n rows, the last valid position's) when n <= 64, and its
    attention to K5 when T <= 16; a prefix build of P rows (``prefix_rows``)
    runs its Linears and its lm_head on all P rows (K4 when P <= 64) and its
    attention on P rows."""
    L, per = layers, engine_launches(layers)
    full = summary["prefills"] - summary["suffix_prefills"] + summary["prefix_builds"]
    out = {k: full * per["full"][k] + summary["suffix_prefills"] * per["suffix"][k] for k in per["full"]}
    shapes, fwd, prefixes = summary["prefill_shapes"], summary["decode_forwards"], summary["prefix_rows"]
    out["decode_attention"] = L * (fwd + sum(t <= 16 for _, t in shapes) + sum(p <= 16 for p in prefixes))
    if quantized:
        out["int8_linear"] = ((linears * L + head) * (fwd + sum(p <= 64 for p in prefixes))
                              + sum(linears * L * (n * t <= 64) + head * (n <= 64) for n, t in shapes))
    return out


def serve_request_file(path: str, vidlm) -> list:
    """dummy_openended_scaled's 32 questions on its 4 videos, 4 text-only
    requests and one naming a missing video file, as the serve command reads
    them (prompts built as eval_openended builds them)."""
    def prompt(message):
        builder = vidlm.llm_backbone.prompt_builder_fn(model_family="merv")
        builder.add_turn(role="human", message=message)
        return builder.get_prompt()

    reqs = [dict(request_id=q["question_id"], prompt=prompt(q["question"]),
                 video=os.path.join(SERVE_DATASET, "videos", f"{q['video_name']}.gif"))
            for q in json.load(open(os.path.join(SERVE_DATASET, "test_q.json")))]
    reqs += [dict(request_id=f"text_{i}", prompt=prompt(m)) for i, m in enumerate(SERVE_TEXT_ONLY)]
    reqs.append(dict(request_id="missing_video", prompt=prompt("What happens here?"),
                     video=os.path.join(SERVE_DATASET, "videos", "no_such_scene.gif")))
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in reqs)
    return reqs


def run_serve_process(argv: list) -> tuple:
    """``python -m merv_tpu_torch.cli.serve`` in a fresh process -> (exit code, stdout, stderr), its caching
    allocator on expandable segments (SERVE_PROCESS_GIB)."""
    proc = subprocess.run([sys.executable, "-m", "merv_tpu_torch.cli.serve"] + argv, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
    return proc.returncode, proc.stdout, proc.stderr


def serve_run(label: str, extra: list, requests: list, request_path: str, run: str = SERVE_RUN,
              layers: int = LLM_LAYERS, head: int = 1) -> dict:
    """One serve run at SERVE_SLOTS slots on ``runs/<run>``: every request must
    get a line, only ``missing_video`` may (and must) fail, and the kernels'
    launches must be as predicted from the engine's counts (for an LLM of
    ``layers`` layers, ``head`` as in ``engine_predicted_launches``)."""
    out_path = os.path.join("runs", f"{run}_{label}.jsonl")
    if os.path.exists(out_path):
        os.remove(out_path)
    argv = ["--model_path", run, "--requests", request_path, "--output", out_path, "--slots", str(SERVE_SLOTS),
            "--max_len", str(SERVE_MAX_LEN), "--max_new_tokens", str(SERVE_MAX_NEW_TOKENS),
            "--allow_random_weights", "true"] + extra
    t = time.perf_counter()
    rc, stdout, stderr = run_serve_process(argv)
    wall = time.perf_counter() - t
    os.makedirs(os.path.join("chiprun_out", "serve"), exist_ok=True)
    with open(os.path.join("chiprun_out", "serve", f"{label}.log"), "w") as f:
        f.write(stderr)
    if rc != 0:
        raise RuntimeError(f"serve {label}: exit {rc}: {stderr[-2000:]}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    rows = {r["request_id"]: r for r in map(json.loads, open(out_path).read().splitlines())}
    shutil.copy(out_path, os.path.join("chiprun_out", "serve", f"{label}.jsonl"))
    missing = sorted({r["request_id"] for r in requests} - set(rows))
    failed = sorted(rid for rid, r in rows.items() if r["finish_reason"] == "error")
    predicted = engine_predicted_launches(summary, quantized="--quantize_llm" in extra, layers=layers, head=head)
    launches = {k: summary["launches"][k] for k in predicted}
    others = {k: v for k, v in summary["launches"].items() if k not in predicted and v}
    phase_lines = [line for line in stderr.splitlines() if "Served" in line or "Phases:" in line]
    log(f"[serve] {label}: python -m merv_tpu_torch.cli.serve {' '.join(argv)}: process wall {wall:.1f} s; "
        f"{json.dumps({k: v for k, v in summary.items() if k != 'launches'})}; launches {launches} (predicted "
        f"{predicted}); {len(rows)} result lines, unanswered {missing}, failed {failed}; "
        + " | ".join(line.split(":: ")[-1] for line in phase_lines))
    if missing or failed != ["missing_video"]:
        raise RuntimeError(f"serve {label}: unanswered {missing}, failed {failed} (only missing_video may fail)")
    if launches != predicted or others:
        raise RuntimeError(f"serve {label}: launches {summary['launches']}, predicted {predicted}")
    return dict(label=label, argv=argv, process_wall_s=wall, summary=summary, launches=launches,
                predicted_launches=predicted, texts={rid: r["text"][:60] for rid, r in rows.items()})


def chunk_checks(vidlm, requests: list, kv_cache_dtype=None, gammas=CHUNK_GAMMAS) -> dict:
    """(a) The engine's decode chunk by graph replay against the same chunk
    function run eagerly from the same state (4 live slots after one
    admission), plain and at gamma 4: greedy tokens must be identical. Then
    the plain chunk's and the verify chunks' (gamma 2, 4, 8) ms per step by
    graph replay at SERVE_SLOTS slots over the full-length cache, which give
    the H100 ``_SPEC_COST_RATIO``, with each graph's capture time and pool.
    ``kv_cache_dtype``: the slot cache's ("int8" or None); ``gammas``: the
    chunks timed (0 and 4 are checked against the eager chunk)."""
    import torch

    from merv_tpu_torch.models.generation import GenerationConfig
    from merv_tpu_torch.serving import ContinuousBatchingEngine, Request

    cfg = GenerationConfig(max_new_tokens=SERVE_MAX_NEW_TOKENS, eos_token_id=vidlm.llm_backbone.stop_token_id,
                           pad_token_id=vidlm.llm_backbone.pad_token_id, kv_cache_dtype=kv_cache_dtype)
    engine = ContinuousBatchingEngine.for_vidlm(vidlm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, config=cfg,
                                                speculative_gamma=4)
    for r in requests[:: 8][:SERVE_SLOTS]:  # one question of each video
        engine.submit(Request(r["request_id"], prompt_text=r["prompt"], video=r["video"],
                              max_new_tokens=SERVE_MAX_NEW_TOKENS))
    engine._admit()
    st = engine._state
    with torch.inference_mode():
        st.done.zero_()
    torch.cuda.synchronize()
    snap = st.snapshot()
    rows = st.k.shape[3]
    out = dict(slots=SERVE_SLOTS, cache_rows=rows, slot_lengths=snap["length"].tolist(), chunks={})
    for gamma in gammas:
        chunk = engine._chunk(gamma)
        window = (lambda c=chunk: (c.wins.clone(), c.emits.clone())) if gamma else (lambda c=chunk: (c.toks.clone(),))
        row = dict(capture_s=chunk.capture_s, pool_mib=chunk.pool_bytes / 2**20)
        if gamma in (0, 4):
            st.restore(snap)
            chunk.run_eager(engine)
            eager = window()
            st.restore(snap)
            chunk.run(engine)
            graph = window()
            row["graph_equals_eager"] = all(torch.equal(a, b) for a, b in zip(eager, graph))
            if gamma:
                row["tokens_per_step"] = (graph[1].sum() / (graph[1] > 0).sum()).item()
        times = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for i in range(CHUNK_TIMED_REPLAYS + 1):
            st.restore(snap)
            torch.cuda.synchronize()
            start.record()
            chunk.run(engine)
            end.record()
            torch.cuda.synchronize()
            if i:  # the first replay warms up
                times.append(start.elapsed_time(end))
        row["ms_per_step"] = sum(times) / len(times) / engine.steps_per_sync
        row["ms_per_step_min"] = min(times) / engine.steps_per_sync
        if gamma in (0, 4):  # one replay under the profiler: where a chunk's device time goes
            st.restore(snap)
            row["profiled_replay"] = profile_decode_step(lambda c=chunk: c.run(engine))
        out["chunks"][gamma] = row
    plain = out["chunks"][0]["ms_per_step"]
    out["spec_cost_ratio"] = {g: out["chunks"][g]["ms_per_step"] / plain for g in gammas if g}
    out["chunk_graphs_alive"] = len(engine._chunks)
    log(f"[engine] chunk graphs at {SERVE_SLOTS} slots, {rows} cache rows (slot lengths {out['slot_lengths']}): "
        + "; ".join(f"gamma {g}: {r['ms_per_step']:.3f} ms/step (min {r['ms_per_step_min']:.3f}), capture "
                    f"{r['capture_s']:.3f} s, pool {r['pool_mib']:.1f} MiB"
                    + (f", graph tokens equal the eager chunk's: {r['graph_equals_eager']}" if "graph_equals_eager"
                       in r else "") for g, r in out["chunks"].items())
        + f"; verify cost / plain step {json.dumps({g: round(v, 4) for g, v in out['spec_cost_ratio'].items()})}")
    for g in (0, 4):
        p = out["chunks"][g]["profiled_replay"]
        out["chunks"][g]["launches_per_run"] = engine._chunks[g].launches_per_run
        log(f"[engine] one replay of the gamma {g} chunk ({engine.steps_per_sync} steps) under the profiler: wall "
            f"{p['wall_ms']:.2f} ms, device {p['device_ms']} ms in {p['kernels']} kernels, idle share "
            f"{p['idle_share']}; largest kernels (ms, launches): "
            + "; ".join(f"{k['ms']:.3f} {k['count']} {k['kernel'][:60]}" for k in p.get("top_kernels", [])))
    del engine
    bad = [g for g, r in out["chunks"].items() if r.get("graph_equals_eager") is False]
    if bad:
        raise RuntimeError(f"engine chunk graph: tokens differ from the eager chunk's at gamma {bad}")
    return out


def agreement(a: dict, b: dict) -> float:
    """Share of equal tokens between two {request_id: token array} maps."""
    return sum(int((a[k] == b[k]).sum()) for k in a) / sum(a[k].size for k in a)


def engine_path(dev, seed: int) -> dict:
    """Phase 4e: write merv-full's run directory (as 4c and 4d do); in this
    process check the chunk graphs (``chunk_checks``) and the engine's greedy
    tokens (b) against ``MERV.generate`` and (c) its speculative form against
    the plain engine; then run the serve command three times in fresh
    processes at once (SERVE_RUNS). The run directory, the request file and the result files are
    deleted at the end; copies go to ``chiprun_out/serve/``."""
    import gc

    import torch

    from merv_tpu_torch import load_vid
    from merv_tpu_torch.models.generation import GenerationConfig
    from merv_tpu_torch.serving import ContinuousBatchingEngine, Request

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_dir = os.path.join("runs", SERVE_RUN)
    write_run_dir(run_dir, dev, seed)
    for name in ("MERV_TPU_TOWER_DIR", "MERV_TPU_LLM_DIR"):  # the random-weights route, whatever the caller set
        os.environ.pop(name, None)
    request_path = os.path.join("runs", f"{SERVE_RUN}_requests.jsonl")
    try:
        vidlm = load_vid(run_dir, allow_random_weights=True)
        requests = serve_request_file(request_path, vidlm)
        torch.cuda.reset_peak_memory_stats()
        stamps = [time.perf_counter()]
        chunks = chunk_checks(vidlm, requests)
        stamps.append(time.perf_counter())

        # (b) and (c): one question of each video and two text-only requests
        picked = requests[::8][:4] + [r for r in requests if r["request_id"].startswith("text_")][:2]
        cfg = GenerationConfig(max_new_tokens=SERVE_MAX_NEW_TOKENS, eos_token_id=vidlm.llm_backbone.stop_token_id,
                               pad_token_id=vidlm.llm_backbone.pad_token_id)
        served = {}
        for name, gamma in (("plain", 0), ("speculative", 4)):
            engine = ContinuousBatchingEngine.for_vidlm(vidlm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, config=cfg,
                                                        speculative_gamma=gamma)
            torch.cuda.synchronize()
            t = time.perf_counter()
            served[name] = engine.run([Request(r["request_id"], prompt_text=r["prompt"], video=r.get("video"),
                                               max_new_tokens=SERVE_MAX_NEW_TOKENS) for r in picked])
            torch.cuda.synchronize()
            served[name + "_stats"] = dict(wall_s=time.perf_counter() - t, tokens_per_step=engine.stats.tokens_per_step,
                                           spec_steps=engine.stats.spec_steps, capture_s=engine.stats.capture_s,
                                           spec_disables=engine.stats.spec_disables)
            del engine
        ref = {r["request_id"]: vidlm.generate_ids(*vidlm._prepare_batch_inputs([r.get("video")], [r["prompt"]]),
                                                   max_new_tokens=SERVE_MAX_NEW_TOKENS)[0].cpu().numpy()
               for r in picked}
        tokens = {name: {k: v.token_ids for k, v in served[name].items()} for name in ("plain", "speculative")}
        errors = [k for name in tokens for k, v in served[name].items() if v.finish_reason == "error"]
        checks = dict(
            engine_vs_generate_agreement=agreement(tokens["plain"], ref),
            first_tokens_equal=sum(int(tokens["plain"][k][0] == ref[k][0]) for k in ref),
            speculative_vs_plain_agreement=agreement(tokens["speculative"], tokens["plain"]),
            plain=served["plain_stats"], speculative=served["speculative_stats"], requests=len(picked),
        )
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        stamps.append(time.perf_counter())
        checks["walls_s"] = dict(setup=stamps[0] - t0, chunks=stamps[1] - stamps[0], agreement=stamps[2] - stamps[1])
        log(f"[engine] in this process: run directory + load_vid {checks['walls_s']['setup']:.1f} s, chunk checks "
            f"{checks['walls_s']['chunks']:.1f} s, (b) + (c) {checks['walls_s']['agreement']:.1f} s")
        log(f"[engine] (b) engine greedy tokens against MERV.generate on {len(picked)} requests: agreement "
            f"{checks['engine_vs_generate_agreement']:.3f}, first tokens equal in {checks['first_tokens_equal']}; "
            f"(c) speculative engine (gamma 4) against the plain engine: agreement "
            f"{checks['speculative_vs_plain_agreement']:.3f}, tokens per verify step "
            f"{checks['speculative']['tokens_per_step']:.3f} over {checks['speculative']['spec_steps']} verify steps "
            f"(monitor disables {checks['speculative']['spec_disables']}); walls {checks['plain']['wall_s']:.2f} / "
            f"{checks['speculative']['wall_s']:.2f} s; peak {peak_gib:.2f} GiB")
        if errors:
            raise RuntimeError(f"engine checks: requests failed {errors}")
        del vidlm
        gc.collect()
        torch.cuda.empty_cache()
        # the serve processes at once, as phase 6 runs its benches, as many as the card's free memory holds at
        # SERVE_PROCESS_GIB each; their walls and rates are read under each other's load
        free, total = torch.cuda.mem_get_info()
        free_gib = free / 2**30
        at_once = max(1, min(len(SERVE_RUNS), int(free_gib // SERVE_PROCESS_GIB)))
        card_memory = dict(free_gib=free_gib, total_gib=total / 2**30,
                           this_allocated_gib=torch.cuda.memory_allocated() / 2**30,
                           this_reserved_gib=torch.cuda.memory_reserved() / 2**30)
        log(f"[engine] before the serve processes: {card_memory}: {at_once} serve processes at once")
        with concurrent.futures.ThreadPoolExecutor(at_once) as pool:
            runs = list(pool.map(lambda run: serve_run(run[0], run[1], requests, request_path), SERVE_RUNS))
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        for path in [request_path] + [os.path.join("runs", f"{SERVE_RUN}_{label}.jsonl") for label, _ in SERVE_RUNS]:
            if os.path.exists(path):
                os.remove(path)
    wall = time.perf_counter() - t0
    log(f"[engine] phase 4e: {wall:.1f} s")
    log(f"[engine] serve processes' peaks, allocated / reserved GiB: "
        f"{ {r['label']: (r['summary']['peak_memory_gib'], r['summary']['peak_reserved_gib']) for r in runs} }")
    return dict(wall_s=wall, chunks=chunks, checks=checks, peak_memory_gib=peak_gib, runs=runs, card_memory=card_memory)


# ---------------------------------------------------------------------------
# phase 4f: int8 serving (weight-only int8 LLM, int8 KV cache)
# ---------------------------------------------------------------------------

INT8_RUN = "chip_smoke_int8"  # runs/<INT8_RUN> (the run directory), its request and result files beside it
INT8_SERVE_ARGS = ["--quantize_llm", "true", "--int8_kv", "true"]  # prefix sharing on (the serve default)


def held_decode_step(vidlm, ids, mask, vids, is_mm, max_new_tokens: int, kv_cache_dtype) -> dict:
    """One eager T=1 decode step from the request's prefill, with every K4 and
    K5 call held against its plain version on the call's own inputs (K4's mag:
    the plain version on |x| and |q|; K5's: on |v| dequantized)."""
    import torch

    import merv_tpu_torch.ops.decode_attention as K5
    import merv_tpu_torch.ops.int8_linear as K4
    from merv_tpu_torch.models import generation as G

    dec = vidlm.llm_backbone.decoder
    calls = {"int8_linear": [], "decode_attention": []}
    k4, k5 = K4.int8_linear, K5.decode_attention

    def k4_held(x, q, scale, bias=None):
        out = k4(x, q, scale, bias)
        calls["int8_linear"].append(hold(out, K4.int8_linear_plain(x, q, scale, bias),
                                         K4.int8_linear_plain(x.abs(), q.abs(), scale, bias)))
        return out

    def k5_held(q, k, v, k_scale=None, v_scale=None, **kw):
        out = k5(q, k, v, k_scale, v_scale, **kw)
        vd = v if v_scale is None else K5.dequantize_kv(v, v_scale, q.dtype)
        kd = k if k_scale is None else K5.dequantize_kv(k, k_scale, q.dtype)
        calls["decode_attention"].append(hold(out, K5.decode_attention_plain(q, k, v, k_scale, v_scale, **kw),
                                              K5.decode_attention_plain(q, kd, vd.abs(), **kw)))
        return out

    with torch.inference_mode():
        embeds, emask = vidlm.build_inputs_embeds(ids, mask, vids, is_mm)
        B, T = embeds.shape[:2]
        cfg = vidlm._generation_config(max_new_tokens, False, 1.0, 1.0, 0, 1, kv_cache_dtype)
        runner, _ = G.decode_runner(dec, B, T + max_new_tokens, cfg, embeds.device)
        logits, _, n_valid = G.prefill(dec, embeds, emask.long(), T + max_new_tokens, cache=runner.cache)
        cache_mask = torch.cat([emask.bool(), torch.ones((B, max_new_tokens), dtype=torch.bool, device=emask.device)],
                               dim=1)
        runner.load(logits.argmax(-1), n_valid, cache_mask, T, None)
        with patched((K4, "int8_linear", k4_held), (K5, "decode_attention", k5_held)):
            runner.step(dec)
        torch.cuda.synchronize()
    return {name: dict(calls=len(c), ok=all(x["ok"] for x in c),
                       worst_share_of_limit=max((x["worst_share_of_limit"] for x in c), default=0.0),
                       worst_mean_share=max((x["mean_abs_err"] / x["mean_limit"] for x in c), default=0.0))
            for name, c in calls.items()}


def int8_path(dev, seed: int, max_new_tokens: int, bf16_step_ms=None, bf16_tokens=None) -> dict:
    """Phase 4f: merv-full's run directory (as 4c writes it) loaded with
    ``quantize_llm=True``; (a) one request through ``MERV.generate`` with
    ``kv_cache_dtype="int8"``, launches counted and predicted, every K4 and K5
    call of one eager decode step held against its plain version, the graph
    step's tokens against the eager loop's and its ms beside phase 4's bf16
    step (``bf16_step_ms``); (b) the engine's plain and gamma-4 chunk graphs on
    the int8 model and cache against the eager chunk, ms per step; (c) one
    ``cli/serve.py --quantize_llm --int8_kv`` process with prefix sharing on
    4e's 37 requests, launches predicted from the engine's counts; (d) weight
    bytes and peak memory. Agreement with 4c's bf16 tokens (``bf16_tokens``)
    is reported, not gated: random weights."""
    import gc

    import torch

    import merv_tpu_torch.ops.attention as A
    from merv_tpu_torch import load_vid
    from merv_tpu_torch.nn.core import Linear

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_dir = os.path.join("runs", INT8_RUN)
    write_run_dir(run_dir, dev, seed)
    for name in ("MERV_TPU_TOWER_DIR", "MERV_TPU_LLM_DIR"):  # the random-weights route, whatever the caller set
        os.environ.pop(name, None)
    request_path = os.path.join("runs", f"{INT8_RUN}_requests.jsonl")
    try:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        vidlm, cfg = load_vid(run_dir, get_model_cfg=True, allow_random_weights=True, quantize_llm=True)
        torch.cuda.synchronize()
        load_s, load_peak_gib = time.perf_counter() - t, torch.cuda.max_memory_allocated() / 2**30
        linears = [m for m in vidlm.llm_backbone.modules() if isinstance(m, Linear)]
        if any(m.weight is not None or m.weight_q.dtype != torch.int8 for m in linears):
            raise RuntimeError("quantize_llm: an LLM Linear kept a float weight")
        n_q = sum(m.weight_q.numel() for m in linears)
        weights = dict(linears=len(linears), int8_bytes=n_q, scale_bytes=4 * sum(m.scale.numel() for m in linears),
                       bf16_bytes_of_the_same=2 * n_q,
                       llm_bytes_total=sum(t.numel() * t.element_size() for t in vidlm.llm_backbone.state_dict().values()))
        log(f"[int8] load_vid(quantize_llm=True): {load_s:.2f} s, peak {load_peak_gib:.2f} GiB; "
            f"{len(linears)} LLM Linears in int8: {n_q / 1e9:.3f} GB of int8 weights + "
            f"{weights['scale_bytes'] / 1e6:.2f} MB of scales (bf16: {2 * n_q / 1e9:.3f} GB), LLM state "
            f"{weights['llm_bytes_total'] / 1e9:.3f} GB")

        # (a) one request, int8 weights and cache
        video, frames_from, _ = demo_video(seed)
        prompt = vidlm.llm_backbone.prompt_builder_fn("merv").get_potential_prompt("What is happening in this video?")
        vidlm.generate(video, prompt, num_frames=cfg.num_frames, max_new_tokens=2, kv_cache_dtype="int8")  # warm-up
        torch.cuda.synchronize()
        A.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        t = time.perf_counter()
        text = vidlm.generate(video, prompt, num_frames=cfg.num_frames, max_new_tokens=max_new_tokens,
                              kv_cache_dtype="int8", timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = A.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        steps = timings["decode_steps"] + (2 if timings["decode_capture_s"] > 0 else 0)  # replays + capture warm-up
        L = LLM_LAYERS
        predicted = dict(LOADED_REQUEST_LAUNCHES, int8_linear=1 + (PACKED_LINEARS * L + 1) * steps,
                         decode_attention=L * steps)
        request = dict(wall_s=wall, prepare_s=timings["prepare_s"], towers_s=timings["towers_s"],
                       prefill_s=timings["prefill_s"], decode_s=timings["decode_s"],
                       decode_steps=timings["decode_steps"], decode_capture_s=timings["decode_capture_s"],
                       decode_tokens_per_s=timings["decode_steps"] / timings["decode_s"] if timings["decode_steps"]
                       else None, text=text, launches=counts, predicted_launches=predicted, peak_memory_gib=peak_gib)
        log(f"[int8] request on {frames_from} frames (int8 weights, int8 cache): wall {wall:.3f} s = prepare "
            f"{request['prepare_s']:.3f} + towers {request['towers_s']:.3f} + prefill {request['prefill_s']:.3f} + "
            f"decode {request['decode_s']:.3f} s ({timings['decode_steps']} steps, {request['decode_tokens_per_s']} "
            f"tok/s) + capture {request['decode_capture_s']:.3f} s; launches {counts} (predicted {predicted}); "
            f"peak {peak_gib:.2f} GiB")
        wrong = {k: (counts[k], n) for k, n in predicted.items() if counts[k] != n}
        if wrong:
            raise RuntimeError(f"int8 request: launches (got, predicted) {wrong}")
        ids, mask, vids, is_mm = vidlm._prepare_batch_inputs([video], [prompt], cfg.num_frames)
        tokens = vidlm.generate_ids(ids, mask, vids, is_multimodal=is_mm, max_new_tokens=max_new_tokens,
                                    kv_cache_dtype="int8")[0].tolist()
        request["tokens"] = tokens
        if bf16_tokens is not None:
            request["agreement_with_bf16"] = sum(a == b for a, b in zip(tokens, bf16_tokens)) / len(tokens)
            request["first_token_equal_bf16"] = tokens[0] == bf16_tokens[0]
        held = held_decode_step(vidlm, ids, mask, vids, is_mm, max_new_tokens, "int8")
        log(f"[int8] one eager decode step, each kernel call against its plain version: {show(held)}; greedy "
            f"agreement with 4c's bf16 model {request.get('agreement_with_bf16')} (first token equal: "
            f"{request.get('first_token_equal_bf16')}; reported, not gated)")
        for name, h in held.items():
            if h["calls"] != (PACKED_LINEARS * L + 1 if name == "int8_linear" else L) or not h["ok"]:
                raise RuntimeError(f"int8 decode step: {name} {h['calls']} calls, or a call outside its limit")
        graph = decode_graph_check(vidlm, ids, mask, vids, is_mm, max_new_tokens, seed, kv_cache_dtype="int8",
                                   sampled=False)["greedy"]
        step_ms = graph["graph"]["ms_per_step"]
        log(f"[int8] decode step by graph replay: {step_ms:.3f} ms (bf16 weights and cache, phase 4: "
            f"{bf16_step_ms if bf16_step_ms is None else round(bf16_step_ms, 3)} ms); launches per step "
            f"{graph['launches_per_step']}")

        # (b) the engine's chunk graphs on the int8 model and cache
        requests = serve_request_file(request_path, vidlm)
        chunks = chunk_checks(vidlm, requests, kv_cache_dtype="int8", gammas=(0, 4))
        del vidlm
        gc.collect()
        torch.cuda.empty_cache()
        # (c) one serve process
        run = serve_run("int8", INT8_SERVE_ARGS, requests, request_path, run=INT8_RUN)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        for path in (request_path, os.path.join("runs", f"{INT8_RUN}_int8.jsonl")):
            if os.path.exists(path):
                os.remove(path)
    wall = time.perf_counter() - t0
    log(f"[int8] phase 4f: {wall:.1f} s")
    return dict(wall_s=wall, load_s=load_s, load_peak_memory_gib=load_peak_gib, weights=weights,
                frames_from=frames_from, request=request, held_call_by_call=held, decode_graph=graph,
                step_ms=step_ms, bf16_step_ms=bf16_step_ms, chunks=chunks, run=run)


def family_kernel_cases(dev, seed: int):
    """Phase 3 at the LLM families' shapes: K2 (FAMILY_FLASH_CASES), K4
    (FAMILY_K4_SHAPES) and K5 (FAMILY_K5_CASES), each held against its plain
    version and timed beside its library call and its bound as the main
    paths' cases are."""
    return (kernel_cases(dev, seed + 5, k1=False, flash_cases=FAMILY_FLASH_CASES)
            + int8_kernel_cases(dev, seed + 5, k4_shapes=FAMILY_K4_SHAPES, k5_cases=FAMILY_K5_CASES))


def family_summary(families: dict) -> dict:
    """Phase 4g's numbers per model, without the profiles."""
    keys = ("wall_s", "prefill_s", "decode_s", "step_ms", "eager_step_ms", "launches", "launches_per_step",
            "peak_memory_gib", "embeds_rel_diff", "logits_rel_diff", "greedy_agreement")
    out = {}
    for label, m in families["models"].items():
        row = {k: v for k, v in m.items() if k not in ("request", "int8_request", "int8_chunks", "serve_run")}
        row["request"] = {k: m["request"].get(k) for k in keys}
        if "int8_request" in m:
            row["int8_request"] = {k: m["int8_request"].get(k) for k in keys}
            row["int8_chunks"] = {g: {k: v for k, v in r.items() if k != "profiled_replay"}
                                  for g, r in m["int8_chunks"]["chunks"].items()}
            row["serve_run"] = {k: m["serve_run"][k] for k in ("process_wall_s", "summary")}
        out[label] = row
    return dict(out, wall_s=families["wall_s"])


# ---------------------------------------------------------------------------
# phase 4f, continued: the packed serving layout against the unpacked one (Llama-2-7B)
# ---------------------------------------------------------------------------

PACKED_RUN = "chip_smoke_packed"




PACKED_TIMED_ROUNDS = 3  # interleaved rounds of the packed and the unpacked step's timing (packed, unpacked, unpacked, packed)


def step_timer(vidlm, ids, mask, vids, is_mm, max_new_tokens: int, kv_cache_dtype=None):
    """A callable giving the ms per step of the request's decode graph
    (``max_new_tokens - 1`` replays between CUDA events, from the same state
    each time), and the runner it replays."""
    import torch

    from merv_tpu_torch.models import generation as G

    dec = vidlm.llm_backbone.decoder
    with torch.inference_mode():
        embeds, emask = vidlm.build_inputs_embeds(ids, mask, vids, is_mm)
        B, T = embeds.shape[:2]
        cfg = vidlm._generation_config(max_new_tokens, False, 1.0, 1.0, 0, 1, kv_cache_dtype)
        runner, _ = G.decode_runner(dec, B, T + max_new_tokens, cfg, embeds.device)
        logits, _, n_valid = G.prefill(dec, embeds, emask.long(), T + max_new_tokens, cache=runner.cache)
    first = logits.argmax(-1)
    cache_mask = torch.cat([emask.bool(), torch.ones((B, max_new_tokens), dtype=torch.bool, device=emask.device)], 1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed() -> float:
        with torch.inference_mode():  # the runner's state tensors were made under it
            runner.load(first, n_valid, cache_mask, T, None)
            torch.cuda.synchronize()
            start.record()
            for _ in range(max_new_tokens - 1):
                runner.replay()
            end.record()
            torch.cuda.synchronize()
        return start.elapsed_time(end) / (max_new_tokens - 1)

    return timed


def packed_check(dev, seed: int, max_new_tokens: int) -> dict:
    """merv-full (as 4c writes it) loaded with ``pack_llm`` True (the default)
    and False side by side, with bf16 weights, then with int8 weights (and
    cache). The same request through each: the packed load's prefill
    last-position logits held against the unpacked one's (relative L2,
    LOGITS_REL_TOL), greedy agreement reported; each through the same decode
    path (``decode_graph_check``, greedy): graph tokens equal to the eager
    loop's, the kernels one step launches (K4 129 packed and 225 unpacked: 4
    or 7 Linears a layer and the lm_head), one profiled replay's cuBLAS GEMMs;
    then the two steps' ms by graph replay in interleaved rounds
    (PACKED_TIMED_ROUNDS)."""
    import gc

    import torch

    from merv_tpu_torch import load_vid
    from merv_tpu_torch.models.generation import prefill

    t0 = time.perf_counter()
    run_dir = os.path.join("runs", PACKED_RUN)
    write_run_dir(run_dir, dev, seed)
    for name in ("MERV_TPU_TOWER_DIR", "MERV_TPU_LLM_DIR"):
        os.environ.pop(name, None)
    out = {}
    try:
        video, _, _ = demo_video(seed)
        for quant in (False, True):
            kv, kind = ("int8" if quant else None), ("int8" if quant else "bf16")
            p, u = f"{kind}_packed", f"{kind}_unpacked"
            gc.collect()
            torch.cuda.empty_cache()
            kept, timers = {}, {}
            for label, pack in ((p, True), (u, False)):
                vidlm, cfg = load_vid(run_dir, get_model_cfg=True, allow_random_weights=True, pack_llm=pack,
                                      quantize_llm=quant)
                if ("qkv_proj" in vidlm.llm_backbone.decoder.layers[0].attn._modules) != pack:
                    raise RuntimeError(f"load_vid(pack_llm={pack}): the decoder's layout is not as asked")
                prompt = vidlm.llm_backbone.prompt_builder_fn("merv").get_potential_prompt(
                    "What is happening in this video?")
                ids, mask, vids, is_mm = vidlm._prepare_batch_inputs([video], [prompt], cfg.num_frames)
                with torch.inference_mode():
                    embeds, emask = vidlm.build_inputs_embeds(ids, mask, vids, is_mm)
                    logits = prefill(vidlm.llm_backbone.decoder, embeds, emask.long(),
                                     embeds.shape[1] + max_new_tokens)[0].float()
                tokens = vidlm.generate_ids(ids, mask, vids, is_multimodal=is_mm, max_new_tokens=max_new_tokens,
                                            kv_cache_dtype=kv)[0]
                graph = decode_graph_check(vidlm, ids, mask, vids, is_mm, max_new_tokens, seed, kv_cache_dtype=kv,
                                           sampled=False)["greedy"]
                prof = graph["graph"]["profiled_step"]
                out[label] = dict(step_ms=graph["graph"]["ms_per_step"], eager_ms=graph["eager"]["ms_per_step"],
                                  launches_per_step=graph["launches_per_step"], step_kernels=prof["kernels"],
                                  step_device_ms=prof["device_ms"], gemm_kernels=prof["gemm_kernels"],
                                  gemm_ms=prof["gemm_ms"], idle_share=prof["idle_share"],
                                  top_kernels=prof.get("top_kernels"), readings=[])
                kept[label] = (logits, tokens, vidlm)
                timers[label] = step_timer(vidlm, ids, mask, vids, is_mm, max_new_tokens, kv)
                del embeds, emask
            for _ in range(PACKED_TIMED_ROUNDS):
                for label in (p, u, u, p):
                    out[label]["readings"].append(timers[label]())
            for label in (p, u):
                out[label]["interleaved_step_ms"] = min(out[label]["readings"])
            out[p]["logits_rel_diff_to_unpacked"] = rel_l2(kept[p][0], kept[u][0])
            out[p]["greedy_agreement_with_unpacked"] = (kept[p][1] == kept[u][1]).float().mean().item()
            del kept, timers, vidlm  # the timers' graphs read the models' weights: freed only now
            k4 = {lab: out[lab]["launches_per_step"].get("int8_linear", 0) for lab in (p, u)}
            log(f"[packed] {p} against {u}: prefill logits rel L2 {out[p]['logits_rel_diff_to_unpacked']:.3e} (tol "
                f"{LOGITS_REL_TOL}), greedy agreement {out[p]['greedy_agreement_with_unpacked']:.3f}; decode step "
                f"by graph replay, interleaved (best of {2 * PACKED_TIMED_ROUNDS}): "
                f"{out[p]['interleaved_step_ms']:.4f} / {out[u]['interleaved_step_ms']:.4f} ms (readings "
                f"{[round(x, 4) for x in out[p]['readings']]} / {[round(x, 4) for x in out[u]['readings']]}); K4 a "
                f"step {k4[p]} / {k4[u]}; one profiled replay: {out[p]['step_kernels']} / {out[u]['step_kernels']} "
                f"kernels, cuBLAS GEMMs {out[p]['gemm_kernels']} / {out[u]['gemm_kernels']} ({out[p]['gemm_ms']:.3f} "
                f"/ {out[u]['gemm_ms']:.3f} ms)")
            if not out[p]["logits_rel_diff_to_unpacked"] <= LOGITS_REL_TOL:
                raise RuntimeError(f"packed layout: logits differ from the unpacked layout's beyond {LOGITS_REL_TOL}")
            want = {p: PACKED_LINEARS * LLM_LAYERS + 1, u: UNPACKED_LINEARS * LLM_LAYERS + 1} if quant else {p: 0, u: 0}
            if k4 != want:
                raise RuntimeError(f"packed layout: K4 launches a step {k4}, predicted {want}")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[packed] packed against unpacked: {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 4g: the LLM families (Qwen-2.5-7B in full; Llama-3.1-8B, Qwen-2.5-3B, LLaVA-1.5-13B one request each)
# ---------------------------------------------------------------------------

FAMILY_RUN = "chip_smoke_family"  # runs/<FAMILY_RUN> (each model's run directory in turn)
FAMILY_FULL = "qwen2.5-7b-instruct"
# (label, the model dict's LLM id, or a registered model id whose config gives the whole dict)
FAMILY_MODELS = (
    ("qwen2.5-7b-instruct", dict(llm_backbone_id="qwen2.5-7b-instruct")),
    ("llama3.1-8b-chat", dict(llm_backbone_id="llama3.1-8b-chat")),
    ("qwen2.5-3b-instruct", dict(llm_backbone_id="qwen2.5-3b-instruct")),
    ("reproduction-llava-v15+13b", dict(model_id="reproduction-llava-v15+13b")),
)


def family_model_dict(spec: dict) -> dict:
    """merv-full's model dict with another LLM, or a registered model's config as a model dict."""
    import dataclasses

    from merv_tpu_torch.conf import ModelConfig

    if "model_id" in spec:
        cfg = dataclasses.asdict(ModelConfig.get_choice_class(spec["model_id"])())
        return {k: cfg[k] for k in MERV_FULL_MODEL}
    return dict(MERV_FULL_MODEL, **spec)


def request_launches(layers: int, steps: int, int8: bool = False, head: int = 1, towers=None) -> dict:
    """A request's launches: the towers' K1 / K2 (``towers``: their counts,
    merv-full's by default), K2 in each LLM layer of the prefill, K5 in each
    layer of every decode step (``steps``: replays and the capture's warm-ups)
    and, with int8 weights, K4 on each packed Linear of a step and on the
    lm_head (``head``: 0 for a tied one, a bf16 matmul) of the prefill's last
    position and of each step."""
    k1, k2 = (TOWER_K1, TOWER_K2) if towers is None else towers
    out = dict(LOADED_REQUEST_LAUNCHES, small_attention_kt=k1, flash_attention_forward=k2 + layers,
               decode_attention=layers * steps, int8_linear=0)
    if int8:
        out["int8_linear"] = head + (PACKED_LINEARS * layers + head) * steps
    return out


def family_request(vidlm, cfg, video, max_new_tokens: int, seed: int, kv_cache_dtype=None, towers=None) -> dict:
    """One request on ``video``: a warm-up, then ``MERV.generate`` with the
    launch counters zeroed just before and read just after (as predicted by
    ``request_launches``); for bf16 weights the request against its
    ``impl="plain"`` rerun (spliced embeddings, prefill logits, greedy
    tokens) and every K1 / K2 call of the prefill held against its plain
    version, for int8 weights every K4 / K5 call of one eager decode step;
    then the decode graph's tokens and step logits against the eager loop's,
    with its ms per step and one profiled replay. ``towers``: the towers'
    (K1, K2) launches a request, merv-full's by default."""
    import torch

    import merv_tpu_torch.ops.attention as A

    llm = vidlm.llm_backbone
    dcfg, int8 = llm.decoder_config, llm.decoder.layers[0].attn.o_proj.weight is None
    head = 0 if dcfg.tie_word_embeddings else 1
    builder = llm.prompt_builder_fn("merv")
    builder.add_turn("human", "What is happening in this video?")
    prompt = builder.get_prompt()
    vidlm.generate(video, prompt, num_frames=cfg.num_frames, max_new_tokens=2, kv_cache_dtype=kv_cache_dtype)
    torch.cuda.synchronize()
    A.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t = time.perf_counter()
    text = vidlm.generate(video, prompt, num_frames=cfg.num_frames, max_new_tokens=max_new_tokens,
                          kv_cache_dtype=kv_cache_dtype, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = A.launch_counts()
    steps = timings["decode_steps"] + (2 if timings["decode_capture_s"] > 0 else 0)
    predicted = request_launches(dcfg.num_layers, steps, int8, head, towers)
    row = dict(wall_s=wall, prepare_s=timings["prepare_s"], towers_s=timings["towers_s"],
               project_fuse_s=timings["project_fuse_s"], prefill_s=timings["prefill_s"], decode_s=timings["decode_s"], decode_steps=timings["decode_steps"],
               decode_capture_s=timings["decode_capture_s"], text=text, launches=counts, predicted_launches=predicted,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    wrong = {k: (counts[k], n) for k, n in predicted.items() if counts[k] != n}
    ids, mask, vids, is_mm = vidlm._prepare_batch_inputs([video], [prompt], cfg.num_frames)
    if llm.bos_token_length == 0 and int(ids[0, 0]) == llm.tokenizer.bos_token_id:
        raise RuntimeError("a family without BOS got a BOS id first")
    if int8:
        row["held_call_by_call"] = held = held_decode_step(vidlm, ids, mask, vids, is_mm, max_new_tokens,
                                                           kv_cache_dtype)
        want = {"int8_linear": PACKED_LINEARS * dcfg.num_layers + head, "decode_attention": dcfg.num_layers}
        bad = {n: h["calls"] for n, h in held.items() if h["calls"] != want[n] or not h["ok"]}
    else:
        _, run_held, compare = request_checks(vidlm, ids, mask, vids, is_mm, cfg.visual_feature_length,
                                              max_new_tokens)
        row.update(compare()[0])
        row["held_call_by_call"] = held = run_held()
        bad = {n: h["calls"] for n, h in held.items() if h["calls"] == 0 or not h["ok"]}
        if not (row["embeds_rel_diff"] <= EMBEDS_REL_TOL and row["logits_rel_diff"] <= LOGITS_REL_TOL):
            bad["whole_path"] = (row["embeds_rel_diff"], row["logits_rel_diff"])
    graph = decode_graph_check(vidlm, ids, mask, vids, is_mm, max_new_tokens, seed, kv_cache_dtype=kv_cache_dtype,
                               sampled=False)["greedy"]
    row.update(step_ms=graph["graph"]["ms_per_step"], eager_step_ms=graph["eager"]["ms_per_step"],
               launches_per_step=graph["launches_per_step"], decode_graph=graph)
    log(f"[family] {vidlm.llm_backbone.identifier} ({'int8 weights, ' + str(kv_cache_dtype) + ' cache' if int8 else 'bf16'}"
        f"): wall {wall:.3f} s = prepare {row['prepare_s']:.3f} + towers {row['towers_s']:.3f} + projectors and "
        f"fusion {row['project_fuse_s']:.3f} + prefill "
        f"{row['prefill_s']:.3f} + decode {row['decode_s']:.3f} s ({row['decode_steps']} steps) + capture "
        f"{row['decode_capture_s']:.3f} s; launches {counts} (predicted {predicted}); peak "
        f"{row['peak_memory_gib']:.2f} GiB; " + (
            f"kernels vs plain: embeds {row['embeds_rel_diff']:.3e}, logits {row['logits_rel_diff']:.3e}, greedy "
            f"agreement {row['greedy_agreement']:.3f}; " if not int8 else "")
        + f"call by call: {show(held)}; decode step {row['step_ms']:.3f} ms by graph replay (eager "
        f"{row['eager_step_ms']:.2f}), launches a step {row['launches_per_step']}")
    if wrong or bad:
        raise RuntimeError(f"{llm.identifier}: launches (got, predicted) {wrong}; failed holds {bad}")
    return row


def as_fp16_storage(decoder):
    """The decoder's float parameters stored in fp16, as ``merv_tpu`` stores
    Qwen-2.5: each use casts to bf16 again (exact here: the bf16 values came
    from fp16 ones)."""
    import torch

    from merv_tpu_torch.models.generation import release_decode_runners

    release_decode_runners(decoder)  # their graphs hold the bf16 tensors this replaces
    with torch.no_grad():
        for p in decoder.parameters():
            if p.dtype == torch.bfloat16:
                p.data = p.data.to(torch.float16)


def families_path(dev, seed: int, max_new_tokens: int) -> dict:
    """Phase 4g. Each of FAMILY_MODELS from a run directory (merv-full's
    towers and projectors at full width, the family's LLM at full width and
    depth, random weights) loaded by ``load_vid``: one request each
    (``family_request``) and the peak memory. Qwen-2.5-7B in full besides:
    its decode step again with the weights stored in fp16 and cast at every
    use (``as_fp16_storage``: the same tokens and step logits, bit for bit,
    and the time the per-call copies cost); then with ``quantize_llm=True``
    an int8-cache request, the engine's plain and gamma-4 chunk graphs
    against the eager chunk, and one ``cli/serve.py --quantize_llm --int8_kv``
    process on 4e's 37 requests."""
    import gc

    import torch

    from merv_tpu_torch import load_vid

    t0 = time.perf_counter()
    run_dir = os.path.join("runs", FAMILY_RUN)
    request_path = os.path.join("runs", f"{FAMILY_RUN}_requests.jsonl")
    for name in ("MERV_TPU_TOWER_DIR", "MERV_TPU_LLM_DIR"):
        os.environ.pop(name, None)
    video, frames_from, _ = demo_video(seed)
    out = dict(frames_from=frames_from, models={})
    try:
        for label, spec in FAMILY_MODELS:
            gc.collect()
            torch.cuda.empty_cache()
            write_run_dir(run_dir, dev, seed, family_model_dict(spec))
            before = torch.cuda.memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            vidlm, cfg = load_vid(run_dir, get_model_cfg=True, allow_random_weights=True)
            torch.cuda.synchronize()
            load_s, load_peak = time.perf_counter() - t, torch.cuda.max_memory_allocated() / 2**30
            loaded = torch.cuda.memory_allocated() / 2**30
            llm = vidlm.llm_backbone
            dtypes = sorted({str(p.dtype) for p in llm.parameters()})
            if dtypes != ["torch.bfloat16"] or "qkv_proj" not in llm.decoder.layers[0].attn._modules:
                raise RuntimeError(f"{label}: LLM not packed in bf16 after load_vid: {dtypes}")
            c = llm.decoder_config
            model = dict(llm=llm.identifier, model_id=cfg.model_id, layers=c.num_layers, hidden=c.hidden_size,
                         heads=c.num_heads, kv_heads=c.num_kv_heads, vocab=c.vocab_size, tied=c.tie_word_embeddings,
                         bias=c.attention_bias, stored_dtype=str(llm.half_precision_dtype), has_bos=llm.spec.has_bos,
                         params=sum(p.numel() for p in vidlm.parameters()), load_s=load_s,
                         load_peak_memory_gib=load_peak, allocated_before_load_gib=before,
                         allocated_after_load_gib=loaded)
            log(f"[family] {label}: load_vid {load_s:.2f} s, allocated {before:.2f} GiB before and {loaded:.2f} after, "
                f"peak {load_peak:.2f} GiB, {model['params'] / 1e9:.3f} B "
                f"params; LLM {c.num_layers} layers, hidden {c.hidden_size}, {c.num_heads} -> {c.num_kv_heads} heads, "
                f"vocab {c.vocab_size}, tied {c.tie_word_embeddings}, bias {c.attention_bias}, stored "
                f"{llm.half_precision_dtype} (rounded once to bf16), BOS {llm.spec.has_bos}")
            del llm  # a name left holding the LLM would keep it allocated into the next model's load
            model["request"] = family_request(vidlm, cfg, video, max_new_tokens, seed)
            if label == FAMILY_FULL:
                ids, mask, vids, is_mm = vidlm._prepare_batch_inputs(
                    [video], [vidlm.llm_backbone.prompt_builder_fn("merv").get_potential_prompt("What is it?")],
                    cfg.num_frames)
                rounded = decode_graph_check(vidlm, ids, mask, vids, is_mm, max_new_tokens, seed, sampled=False)
                g_round = rounded["greedy"]
                tok_round = vidlm.generate_ids(ids, mask, vids, is_multimodal=is_mm, max_new_tokens=max_new_tokens)
                as_fp16_storage(vidlm.llm_backbone.decoder)
                g16 = decode_graph_check(vidlm, ids, mask, vids, is_mm, max_new_tokens, seed, sampled=False)["greedy"]
                tok16 = vidlm.generate_ids(ids, mask, vids, is_multimodal=is_mm, max_new_tokens=max_new_tokens)
                model["fp16_storage"] = dict(
                    step_ms_fp16_per_call_cast=g16["graph"]["ms_per_step"],
                    step_ms_bf16_rounded=g_round["graph"]["ms_per_step"],
                    device_ms_fp16=g16["graph"]["profiled_step"]["device_ms"],
                    device_ms_bf16=g_round["graph"]["profiled_step"]["device_ms"],
                    kernels_fp16=g16["graph"]["profiled_step"]["kernels"],
                    kernels_bf16=g_round["graph"]["profiled_step"]["kernels"],
                    tokens_equal=bool(torch.equal(tok16, tok_round)))
                log(f"[family] {label} decode step, weights stored fp16 and cast at each use: "
                    f"{model['fp16_storage']['step_ms_fp16_per_call_cast']:.3f} ms by graph replay "
                    f"({model['fp16_storage']['kernels_fp16']} kernels) against "
                    f"{model['fp16_storage']['step_ms_bf16_rounded']:.3f} ms rounded once to bf16 at load "
                    f"({model['fp16_storage']['kernels_bf16']} kernels); greedy tokens equal: "
                    f"{model['fp16_storage']['tokens_equal']}")
                if not model["fp16_storage"]["tokens_equal"]:
                    raise RuntimeError(f"{label}: fp16 storage cast per call gives other tokens than bf16 rounded once")
                del vidlm
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                vidlm, cfg = load_vid(run_dir, get_model_cfg=True, allow_random_weights=True, quantize_llm=True)
                model["int8_request"] = family_request(vidlm, cfg, video, max_new_tokens, seed, kv_cache_dtype="int8")
                requests = serve_request_file(request_path, vidlm)
                model["int8_chunks"] = chunk_checks(vidlm, requests, kv_cache_dtype="int8", gammas=(0, 4))
                del vidlm
                gc.collect()
                torch.cuda.empty_cache()
                model["serve_run"] = serve_run("family_int8", INT8_SERVE_ARGS, requests, request_path, run=FAMILY_RUN,
                                               layers=c.num_layers, head=0 if c.tie_word_embeddings else 1)
            else:
                del vidlm
            out["models"][label] = model
            shutil.rmtree(run_dir, ignore_errors=True)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        for path in (request_path, os.path.join("runs", f"{FAMILY_RUN}_family_int8.jsonl")):
            if os.path.exists(path):
                os.remove(path)
        gc.collect()
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"[family] phase 4g: {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 4h: the vision zoo
# ---------------------------------------------------------------------------

ZOO_RUN = "chip_smoke_zoo"  # runs/<ZOO_RUN> (each request's run directory in turn)
# Z1: Hiera-base-plus (32 frames, 2 clips), pooled SigLIP so400m, DINOv2 and LanguageBind (16 frames each) through
# attntv + gelu-mlp and cross_attention_avg_lq_pe; Z2: merv-full's towers through 3dconv + fused-gelu-mlp and
# concat_channel_ln. Both on merv-full's Llama-2-7B at full width and depth.
ZOO_REQUESTS = (
    ("Z1", dict(MERV_FULL_MODEL, arch_specifier="no-align+attntv+gelu-mlp", feature_fusion="cross_attention_avg_lq_pe",
                video_backbone_ids=["hiera-base-plus-video", "siglip-vit-so400m", "dinov2-video-all-tokens",
                                    "languagebind-video-noclass"], num_frames=[32, 16, 16, 16])),
    ("Z2", dict(MERV_FULL_MODEL, arch_specifier="3dconv+fused-gelu-mlp", feature_fusion="concat_channel_ln")),
)
# the towers' (K1, K2) launches a request: K1 on each run layer of so400m (27, full depth for the MAP head), DINOv2
# and LanguageBind (23 each, the penultimate tap); K2 on ViViT's 12 layers; Hiera runs no kernel
ZOO_TOWER_LAUNCHES = {"Z1": (27 + 23 + 23, 0), "Z2": (TOWER_K1, TOWER_K2)}
ZOO_TIMED_TOWERS = ("hiera-base-plus-video", "siglip-vit-so400m")
# so400m under MERV_TPU_FUSED_VIT_BLOCK=1: B6 at head dim 72 on each of its 27 layers (the K1 count of 4h's request),
# K6 on the norms B6 leaves
ZOO_SO400M_FUSED_LAUNCHES = {"fused_vit_attn_block_d72": 27, "layer_norm": TOWER_NORMS["siglip-vit-so400m"][1]}
ZOO_RESAMPLERS = ("avg", "attntv", "conv", "3davg", "3dconv")
ZOO_FUSIONS = ("concat", "concat_channel", "concat_channel_ln", "scalar", "cross_attention_avg_lq",
               "cross_attention_avg_lq_pe")


def zoo_tower_times(vidlm, vids) -> dict:
    """Hiera-base-plus and so400m on the default route and on
    MERV_TPU_TOWER_ATTN=xla, so400m also on MERV_TPU_FUSED_VIT_BLOCK=1 (B6 at
    head dim 72 on each of its 27 layers): ms per tower (CUDA events over 10
    runs), launches of one run, and the output against the same route with
    impl="plain" and plain norms and (so400m under the switch) against the default route's,
    within EMBEDS_REL_TOL (relative L2: the routes round to bf16 at other
    places)."""
    import torch

    import merv_tpu_torch.ops.attention as A

    out = {}
    for vb, v in zip(vidlm.video_backbones, vids):
        if vb.identifier not in ZOO_TIMED_TOWERS:
            continue
        routes = (("default", {}), ("tower_attn_xla", {"MERV_TPU_TOWER_ATTN": "xla"}))
        if vb.identifier == "siglip-vit-so400m":
            routes += (("fused_block", {"MERV_TPU_FUSED_VIT_BLOCK": "1"}),)
        default = None
        for route, env in routes:
            with switches(env), torch.no_grad():
                with plain_norms():
                    ref = vb(v, impl="plain")
                A.reset_launch_counts()
                got = vb(v)
                torch.cuda.synchronize()
                launches = {k: n for k, n in A.launch_counts().items() if n}
                ms = time_ms(lambda: vb(v), 10)
            r = rel_l2(got.float(), ref.float())
            row = dict(ms=ms, launches=launches, rel_diff_plain=r)
            if route == "default":
                default = got
            elif route == "fused_block":
                row["rel_diff_default_route"] = rel_l2(got.float(), default.float())
            out[f"{vb.identifier}/{route}"] = row
            log(f"[zoo] {vb.identifier:24s} {route:16s} {ms:8.3f} ms per tower (shape {list(v.shape)}); launches "
                f"{launches}; vs plain {r:.3e}"
                + (f"; vs the default route {row['rel_diff_default_route']:.3e}" if "rel_diff_default_route" in row else ""))
            if not torch.isfinite(got.float()).all() or not r <= EMBEDS_REL_TOL:
                raise RuntimeError(f"{vb.identifier} on {route}: output differs from plain by {r}")
            if not row.get("rel_diff_default_route", 0.0) <= EMBEDS_REL_TOL:
                raise RuntimeError(f"{vb.identifier} on {route}: output differs from the default route's by "
                                   f"{row['rel_diff_default_route']}")
            if route == "fused_block" and launches != ZOO_SO400M_FUSED_LAUNCHES:
                raise RuntimeError(f"{vb.identifier} on {route}: launches {launches}, predicted "
                                   f"{ZOO_SO400M_FUSED_LAUNCHES}")
    return out


def zoo_projector_sweep(vidlm, vids, seed: int) -> dict:
    """On Z1's tower features, each resampler (gelu-mlp) and each fusion (on the
    attntv projections) at full width, random bf16 weights from a seeded
    generator: the output finite and of the expected shape, and its ms (CUDA
    events over 5 runs)."""
    import torch

    from merv_tpu_torch.device import make_generator
    from merv_tpu_torch.nn import fusion as FU
    from merv_tpu_torch.nn import projectors as P
    from merv_tpu_torch.nn.core import init_weights

    dev = vids[0].device
    g = make_generator(dev, seed + 41)
    llm_dim, vfl, ptl = vidlm.llm_backbone.embed_dim, vidlm.visual_feature_length, vidlm.projector_token_length
    S = math.isqrt(ptl)
    kw = dict(param_dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        feats = [f.reshape(f.shape[0], vb.temporal_resolution, vb.spatial_resolution, f.shape[-1])
                 for f, vb in zip(vidlm.encode_videos(vids), vidlm.video_backbones)]

    def make(kind, vb):
        T, C = vb.temporal_resolution, vb.embed_dim
        return {"avg": lambda: P.AveragePoolingProjector(C, llm_dim, S, T, "gelu-mlp", **kw),
                "attntv": lambda: P.AttentivePooler(C, llm_dim, ptl, 8, T, "gelu-mlp", **kw),
                "conv": lambda: P.ConvolutionalProjector(C, llm_dim, S, 3, T, "gelu-mlp", **kw),
                "3davg": lambda: P.AveragePooling3DProjector(C, llm_dim, T, S, "gelu-mlp", **kw),
                "3dconv": lambda: P.Convolutional3DProjector(C, llm_dim, T, S, "gelu-mlp", **kw)}[kind]()

    out, projected = {}, None
    for kind in ZOO_RESAMPLERS:
        projs = [init_weights(make(kind, vb), g).eval() for vb in vidlm.video_backbones]

        def run():
            with torch.no_grad():
                return [p(f) for p, f in zip(projs, feats)]

        ys = run()
        ok = all(tuple(y.shape) == (1, vfl, llm_dim) and bool(torch.isfinite(y.float()).all()) for y in ys)
        ms = time_ms(run, 5)
        out[kind] = dict(ms=ms, shapes=[list(y.shape) for y in ys], finite_and_shaped=ok,
                         params=sum(q.numel() for p in projs for q in p.parameters()))
        log(f"[zoo] resampler {kind:8s}: {ms:8.3f} ms for the towers, {out[kind]['params'] / 1e6:.1f} M params, "
            f"outputs {out[kind]['shapes']}, finite and [1, {vfl}, {llm_dim}]: {ok}")
        if not ok:
            raise RuntimeError(f"resampler {kind}: output not finite or not [1, {vfl}, {llm_dim}]")
        if kind == "attntv":
            projected = ys
        del projs, ys
    E = len(projected)
    for name in ZOO_FUSIONS:
        if name == "concat":
            module, want = None, (1, E * vfl, llm_dim)
        elif name.startswith("concat_channel"):
            module, want = P.LinearProjector(E * llm_dim, llm_dim, pre_proj_layernorm=name.endswith("_ln"), **kw), \
                (1, vfl, llm_dim)
        elif name == "scalar":
            module, want = FU.ScalarAdapter(E, **kw), (1, vfl, llm_dim)
        else:
            module, want = FU.CrossAttentionAdapterLearnableQuery(
                embed_dim=3072, llm_dim=llm_dim, token_length=vfl, averagetoken=True, num_encoder=E,
                positional_embedding=name.endswith("_pe"), **kw), (1, vfl, llm_dim)
        if module is not None:
            init_weights(module, g).eval()

        def fuse(module=module, name=name):
            with torch.no_grad():
                if module is None:
                    return torch.cat(projected, dim=1)
                if name.startswith("concat_channel"):
                    return module(torch.cat(projected, dim=-1))
                return module(projected)[0]

        y = fuse()
        ok = tuple(y.shape) == want and bool(torch.isfinite(y.float()).all())
        ms = time_ms(fuse, 5)
        out[name] = dict(ms=ms, shape=list(y.shape), finite_and_shaped=ok)
        log(f"[zoo] fusion {name:26s}: {ms:8.3f} ms, output {list(y.shape)}, finite and {list(want)}: {ok}")
        if not ok:
            raise RuntimeError(f"fusion {name}: output not finite or not {want}")
    return out


def zoo_path(dev, seed: int, max_new_tokens: int, requests=None) -> dict:
    """Phase 4h. Each of ZOO_REQUESTS (``requests``: their labels, all by
    default) from a run directory (the towers, projectors and fusion it names
    at full width, merv-full's Llama-2-7B at full width and depth, random
    weights) loaded by ``load_vid``: one request (``family_request``: launches
    as predicted from ZOO_TOWER_LAUNCHES, the request against its plain rerun
    and call by call, the decode graph against the eager loop, peak memory and
    the phase split). On Z1 also the timed towers (``zoo_tower_times``) and,
    on its tower features, every resampler and fusion (``zoo_projector_sweep``)."""
    import gc

    import torch

    from merv_tpu_torch import load_vid

    t0 = time.perf_counter()
    run_dir = os.path.join("runs", ZOO_RUN)
    for name in ("MERV_TPU_TOWER_DIR", "MERV_TPU_LLM_DIR"):
        os.environ.pop(name, None)
    video, frames_from, _ = demo_video(seed)
    out = dict(frames_from=frames_from, requests={})
    try:
        for label, model in ZOO_REQUESTS:
            if requests is not None and label not in requests:
                continue
            gc.collect()
            torch.cuda.empty_cache()
            write_run_dir(run_dir, dev, seed, model)
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            vidlm, cfg = load_vid(run_dir, get_model_cfg=True, allow_random_weights=True)
            torch.cuda.synchronize()
            row = dict(model=model, load_s=time.perf_counter() - t, load_peak_memory_gib=torch.cuda.max_memory_allocated()
                       / 2**30, params=sum(p.numel() for p in vidlm.parameters()),
                       projector_params=sum(p.numel() for p in vidlm.projectors.parameters()),
                       towers=[dict(id=vb.identifier, embed_dim=vb.embed_dim, num_patches=vb.num_patches,
                                    frames=vb.num_frames) for vb in vidlm.video_backbones])
            log(f"[zoo] {label}: {model['arch_specifier']} / {model['feature_fusion']} over {model['video_backbone_ids']}"
                f" ({model['num_frames']} frames): load_vid {row['load_s']:.2f} s, peak {row['load_peak_memory_gib']:.2f}"
                f" GiB, {row['params'] / 1e9:.3f} B params ({row['projector_params'] / 1e6:.1f} M in the projectors)")
            row["request"] = family_request(vidlm, cfg, video, max_new_tokens, seed, towers=ZOO_TOWER_LAUNCHES[label])
            if label == "Z1":
                vids = vidlm._prepare_batch_inputs([video], ["What is it?"], cfg.num_frames)[2]
                row["towers_timed"] = zoo_tower_times(vidlm, vids)
                row["projector_sweep"] = zoo_projector_sweep(vidlm, vids, seed)
                del vids
            del vidlm
            out["requests"][label] = row
            shutil.rmtree(run_dir, ignore_errors=True)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"[zoo] phase 4h: {out['wall_s']:.1f} s")
    return out


def zoo_summary(zoo: dict) -> dict:
    """4h's numbers without the per-call detail, for one JSON line."""
    keys = ("wall_s", "towers_s", "project_fuse_s", "prefill_s", "decode_s", "decode_steps", "step_ms", "eager_step_ms",
            "peak_memory_gib", "launches", "predicted_launches", "embeds_rel_diff", "logits_rel_diff",
            "greedy_agreement")
    return {label: dict(load_s=r["load_s"], params=r["params"], request={k: r["request"].get(k) for k in keys},
                        **{k: r[k] for k in ("towers_timed", "projector_sweep") if k in r})
            for label, r in zoo["requests"].items()}


# ---------------------------------------------------------------------------
# phase 5: the training path (merv-base align stage)
# ---------------------------------------------------------------------------

WORDS = ("a person walks across the room and picks up a red cup then sets it down near the window while a dog "
         "watches from the sofa outside cars pass slowly under grey clouds").split()


class CaptionVideos:
    """Align-stage items made from a seed, with AlignVideoDataset's contract:
    uint8 frames already at each tower's geometry ``[F, S, S, 3]`` (drawn
    from a small pool of random videos made at set-up), a caption of 20-60
    words tokenized with its end-of-sequence token, and its labels (the first
    token ignored)."""

    def __init__(self, n: int, resolutions, tokenizer, seed: int, pool: int = 4):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.videos = [[rng.integers(0, 256, size=r, dtype=np.uint8) for r in resolutions] for _ in range(pool)]
        self.items = []
        for i in range(n):
            caption = " ".join(rng.choice(WORDS, size=int(rng.integers(20, 61))))
            ids = np.asarray(tokenizer(caption + tokenizer.eos_token, truncation=True).input_ids, np.int32)
            labels = ids.copy()
            labels[0] = -100
            self.items.append(dict(input_ids=ids, labels=labels, pool=int(rng.integers(pool))))

    def __getitem__(self, i):
        item = self.items[i]
        return dict(video_values=self.videos[item["pool"]], input_ids=item["input_ids"], labels=item["labels"],
                    is_image=False)

    def __len__(self):
        return len(self.items)


def host_copy(module) -> dict:
    """{parameter name: a copy in host memory}, to hold the module against
    after training with ``torch.equal``."""
    return {name: p.detach().cpu() for name, p in module.named_parameters()}


def changed(module, saved: dict) -> list:
    """Names of the parameters whose values differ from ``saved`` in any bit."""
    import torch

    return [name for name, p in module.named_parameters() if not torch.equal(p.detach(), saved[name].to(p.device))]


def planted_backward_faults():
    """Faulty stand-ins for the plain versions, as (module, name, function):
    faults of the training path's kernels that the call-by-call check must
    catch. The two backward faults show in a causal call's first rows: query
    0 sees one key, so its true dS is exactly 0 (P = 1, delta = dP) and
    dropping delta leaves dP there; a mask shifted by one gives key 1 a P of
    order 1 from query 0. Where attention is spread over many keys,
    delta = dO . O is small and the first fault all but vanishes. The third
    offsets the forward's log-sum-exp, which the backward recomputes P from."""
    import merv_tpu_torch.ops.attention as A

    plain, visible, forward = A.flash_attention_backward_plain, A._visible, A.flash_attention_forward_plain

    def k3_ds_without_delta(q, k, v, o, lse, do, **kw):
        # delta = rowsum(dO o O) is 0 when O is: dS = P o dP
        return plain(q, k, v, o.new_zeros(o.shape), lse, do, **kw)

    def k3_causal_shifted(q, k, v, o, lse, do, **kw):
        # each query also sees the key just after it
        shifted = lambda B, Tq, Tk, causal, mask, off, dev: visible(B, Tq, Tk, causal, mask, off + 1, dev)  # noqa
        with patched((A, "_visible", shifted)):
            return plain(q, k, v, o, lse, do, **kw)

    def k2_lse_offset(q, k, v, *, return_lse=False, **kw):
        # every row's log-sum-exp off by LSE_PLANTED_OFFSET: the backward's P scaled by exp(-offset)
        out = forward(q, k, v, return_lse=return_lse, **kw)
        return (out[0], out[1] + LSE_PLANTED_OFFSET) if return_lse else out

    return {
        "k3_ds_without_delta": (A, "flash_attention_backward_plain", k3_ds_without_delta),
        "k3_causal_shifted": (A, "flash_attention_backward_plain", k3_causal_shifted),
        "k2_lse_offset": (A, "flash_attention_forward_plain", k2_lse_offset),
    }


KERNEL_GROUPS = (  # device kernel name -> group, first match wins
    ("K1 small_attention_kt", ("small_attn_kernel<true>",)),
    ("K2 flash_attention_forward", ("flash_fwd_kernel",)),
    ("K3 flash_attention_backward", ("bwd_dkdv_kernel", "bwd_dq_kernel", "bwd_delta_kernel")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass", "Kernel2")),
)


def profile_micro_step(vidlm, transforms, batch) -> dict:
    """Device time by kernel group, and the device's idle share, over one
    training micro-step (forward, remat recompute and backward), from
    ``torch.profiler``; "not measured" if the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from merv_tpu_torch.training.train_step import make_loss_fn

    loss_fn = make_loss_fn(vidlm, remat=True, video_transforms=transforms, loss_chunk_size=TRAIN_LOSS_CHUNK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        loss_fn(batch).backward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    for p in vidlm.parameters():
        p.grad = None
    # the device-side entries (kernels, copies, sets); operators only launch them
    kernels = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms in kernels)
    if device_ms <= 0:
        log("[profile] the trace holds no device time: kernel split and idle share not measured")
        return dict(wall_ms=wall_ms, device_ms=None)
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    others = []
    for key, ms in kernels:
        g = next((g for g, names in KERNEL_GROUPS if any(n in key for n in names)), "other")
        groups[g] += ms
        if g == "other":
            others.append((ms, key))
    # one stream: kernels do not overlap, so busy time is their sum. A sum
    # above the wall time means events were counted twice: idle share not measured.
    top = [dict(ms=ms, kernel=key[:120]) for ms, key in sorted(others, reverse=True)[:6]]
    idle = 1 - device_ms / wall_ms if device_ms <= wall_ms else None
    out = dict(wall_ms=wall_ms, device_ms=device_ms, idle_share=idle, groups_ms=groups, top_other=top)
    idle_text = "not measured: device time exceeds the wall time" if idle is None else f"{idle:.4f}"
    log(f"[profile] one micro-step of {batch['input_ids'].shape[0]}: wall {wall_ms:.1f} ms, device busy "
        f"{device_ms:.1f} ms (idle share {idle_text}); " +
        ", ".join(f"{g} {ms:.1f} ms ({ms / device_ms:.3f})" for g, ms in groups.items()))
    log("[profile] largest other kernels: " + "; ".join(f"{t['ms']:.1f} ms {t['kernel']}" for t in top))
    return out


def train_path(dev, seed: int, run_dir: str):
    """merv-base's align stage through get_train_strategy -> run_setup ->
    run_training at full width, the LLM at TRAIN_LLM_LAYERS, then the checks
    of the module docstring's phase 5."""
    import gc
    import shutil

    import torch

    import merv_tpu_torch.ops.attention as A
    from merv_tpu_torch.training import Metrics, get_train_strategy
    from merv_tpu_torch.training.checkpointing import load_checkpoint
    from merv_tpu_torch.training.train_step import make_loss_fn
    from merv_tpu_torch.util.data_utils import PaddedCollatorForLanguageModeling

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, vidlm = build_merv_base(dev, seed, projector_dtype=torch.float32, llm_layers=TRAIN_LLM_LAYERS)
    per_device_batch, global_batch, max_steps = cfg.align_per_device_batch_size, TRAIN_GLOBAL_BATCH, TRAIN_STEPS
    vidlm.train()
    vidlm.freeze_backbones("align")
    transforms = [vb.get_video_transform() for vb in vidlm.video_backbones]
    res = [(nf, tf.target_size, tf.target_size, 3) for nf, tf in zip(cfg.num_frames, transforms)]
    ds = CaptionVideos(global_batch * max_steps, res, vidlm.llm_backbone.tokenizer, seed + 2)
    collator = PaddedCollatorForLanguageModeling(cfg.llm_max_length, vidlm.llm_backbone.pad_token_id, res)
    strategy = get_train_strategy(
        cfg.align_train_strategy, vidlm, stage="align", epochs=cfg.align_epochs, max_steps=max_steps,
        global_batch_size=global_batch, per_device_batch_size=per_device_batch,
        learning_rate=cfg.align_learning_rate, weight_decay=cfg.align_weight_decay,
        max_grad_norm=cfg.align_max_grad_norm, lr_scheduler_type=cfg.align_lr_scheduler_type,
        warmup_ratio=cfg.align_warmup_ratio, enable_gradient_checkpointing=True, save_checkpoint_after=1,
        loss_chunk_size=TRAIN_LOSS_CHUNK,
    )
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    strategy.run_setup(run_dir, n_train_examples=len(ds), video_transforms=transforms, seed=seed)
    trainable = vidlm.trainable_mask()
    tnames = [n for n, t in trainable.items() if t]
    init = {n: p.detach().cpu().clone() for n, p in vidlm.named_parameters() if trainable[n]}
    frozen = {k: (m, host_copy(m)) for k, m in (("towers", vidlm.video_backbones), ("llm", vidlm.llm_backbone))}
    micro = strategy.grad_accumulation_steps * max_steps
    torch.cuda.synchronize()
    log(f"[train] built {cfg.model_id} for the align stage in {time.perf_counter() - t0:.1f} s: "
        f"{sum(init[n].numel() for n in tnames) / 1e6:.2f} M trainable parameters (fp32) in {len(tnames)} tensors, "
        f"per-device batch {per_device_batch}, global batch {global_batch} (accumulation "
        f"{strategy.grad_accumulation_steps}), {max_steps} steps, T = {cfg.llm_max_length} + "
        f"{cfg.visual_feature_length}; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    metrics = Metrics(("jsonl",), "smoke", run_dir, {}, "align", grad_accumulation_steps=strategy.grad_accumulation_steps,
                      total_steps=max_steps)
    step_timings = []
    A.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    strategy.run_training(ds, collator, metrics, stage="align", seed=seed, run_dir=run_dir, num_workers=0,
                          step_timings=step_timings)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t
    counts = A.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    metrics.finalize()

    losses = [st["loss"] for st in step_timings]
    logged = [json.loads(x)["Align/Step"] for x in open(os.path.join(run_dir, "smoke.jsonl"))]
    if logged != list(range(1, max_steps + 1)):
        raise RuntimeError(f"the JSONL metrics logged steps {logged}")
    tokens = global_batch * (cfg.llm_max_length + cfg.visual_feature_length)
    for i, st in enumerate(step_timings):
        log(f"[train] step {i + 1}: {st['step_s']:.3f} s = towers {st['towers_s']:.3f} + LLM forward/backward "
            f"{st['llm_s']:.3f} + optimizer {st['optimizer_s']:.4f} (+ rest "
            f"{st['step_s'] - st['towers_s'] - st['llm_s'] - st['optimizer_s']:.3f}); loss {losses[i]:.4f}; "
            f"{tokens / st['step_s']:.0f} tokens/s")
    timed = step_timings[1:]
    step_s = sum(st["step_s"] for st in timed) / len(timed)
    split = {k: sum(st[k] for st in timed) / len(timed) for k in ("towers_s", "llm_s", "optimizer_s")}
    per_micro = {k: v / micro for k, v in counts.items()}
    log(f"[train] steps 2-{max_steps}: {step_s:.3f} s per step, {tokens / step_s:.0f} tokens/s "
        f"({tokens} tokens per step); run_training wall {train_wall:.1f} s; peak memory {peak_gib:.2f} GiB; "
        f"launches {counts} = per micro-step {per_micro} over {micro} micro-steps")

    # checks: finite losses; lr 0 on step 1; trainables moved by step 3; frozen parameters equal to their
    # saved copies; launches
    if len(losses) != max_steps or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"training losses {losses}")
    step1 = next(p for p in os.listdir(os.path.join(run_dir, "checkpoints")) if p.startswith("step-000001-"))
    after1 = load_checkpoint(os.path.join(run_dir, "checkpoints", step1))["model"]
    for n in tnames:
        key, rest = n.split(".", 1)
        if not torch.equal(after1[key][rest], init[n]):
            raise RuntimeError(f"{n} moved on step 1, whose learning rate is 0")
    moved = [n for n, p in vidlm.named_parameters() if trainable[n] and not torch.equal(p.detach().cpu(), init[n])]
    if not moved:
        raise RuntimeError(f"no trainable parameter moved in {max_steps} steps")
    for k, (m, saved) in frozen.items():
        if changed(m, saved):
            raise RuntimeError(f"frozen {k} changed during training: {changed(m, saved)[:5]}")
    del frozen
    expect = {k: v * micro for k, v in TRAIN_LAUNCHES_PER_MICRO_STEP.items()}
    if counts != expect:
        raise RuntimeError(f"training launches {counts}, predicted {expect}")
    log(f"[train] checks: {max_steps} finite losses; trainables bit-identical after step 1 (lr 0) and "
        f"{len(moved)}/{len(tnames)} tensors moved by step {max_steps}; towers and LLM bit-identical; launches as "
        f"predicted")

    profile = profile_micro_step(vidlm, transforms, strategy._put_batch(collator([ds[i] for i in range(per_device_batch)])))

    # kernels vs plain on one micro-batch of 1, every backward-kernel call held against the plain backward
    batch1 = strategy._put_batch(collator([ds[0]]))
    named = [(n, p) for n, p in vidlm.named_parameters() if trainable[n]]

    def micro_step(impl):
        for _, p in named:
            p.grad = None
        with plain_norms() if impl == "plain" else contextlib.nullcontext():
            loss = make_loss_fn(vidlm, remat=True, video_transforms=transforms, loss_chunk_size=TRAIN_LOSS_CHUNK,
                                attn_impl=impl)(batch1)
            loss.backward()
        grads = {key: torch.cat([p.grad.float().flatten() for n, p in named if n.startswith(key + ".")
                                 and p.grad is not None]) for key in vidlm.trainable_module_keys}
        return loss.item(), grads

    def held_micro_step():
        """micro_step("auto") with every backward-kernel call held three ways:
        against the plain backward on the call's own inputs, its lse against
        the plain forward's, and against the plain backward on the plain
        forward's o and lse; and every K6 call of the towers against the
        plain formula on its own inputs (``held_layer_norms``)."""
        calls, norms, kernel = [], [], A.flash_attention_backward

        def held(q, k, v, o, lse, do, **kw):
            grads = kernel(q, k, v, o, lse, do, **kw)
            calls.append(dict(own=hold_backward(q, k, v, o, lse, do, grads, **kw),
                              **hold_from_plain_forward(q, k, v, lse, do, grads, **kw)))
            return grads

        with patched((A, "flash_attention_backward", held)), held_layer_norms(norms):
            micro_step("auto")
        out = dict(calls=len(calls))
        for part in ("own", "lse", "backward"):
            out[part] = dict(ok=all(c[part]["ok"] for c in calls),
                             worst_share_of_limit=max(c[part]["worst_share_of_limit"] for c in calls))
        out["worst_mean_share"] = max(c[p]["worst_mean_share"] for c in calls for p in ("own", "backward"))
        out["layer_norm"] = held_summary(norms)
        out["ok"] = all(out[part]["ok"] for part in ("own", "lse", "backward", "layer_norm"))
        return out

    def show(h):
        ln = h["layer_norm"]
        return (f"own inputs worst/limit {h['own']['worst_share_of_limit']:.3f}; lse worst/limit "
                f"{h['lse']['worst_share_of_limit']:.4f}; from the plain forward's o and lse worst/limit "
                f"{h['backward']['worst_share_of_limit']:.3f}; mean err/mean limit {h['worst_mean_share']:.4f}; "
                f"K6 {ln['calls']} calls, worst/limit {ln['worst_share_of_limit']:.3f}, at most "
                f"{ln.get('max_ulps', 0.0):.3f} bf16 ulps")

    ref_loss, ref_grads = micro_step("plain")
    loss, grads = micro_step("auto")
    rel_loss = abs(loss - ref_loss) / abs(ref_loss)
    rel_grads = {k: ((grads[k] - ref_grads[k]).norm() / ref_grads[k].norm()).item() for k in grads}
    held = held_micro_step()
    log(f"[train] kernels vs plain, one micro-batch of 1 at {TRAIN_LLM_LAYERS} LLM layers: loss {loss:.6f} vs "
        f"{ref_loss:.6f} (relative {rel_loss:.3e}, tol {TRAIN_LOSS_REL_TOL}); gradient relative L2 {rel_grads} "
        f"(tol {TRAIN_GRAD_REL_TOL}); {held['calls']} backward-kernel calls held: {show(held)}")
    if not rel_loss <= TRAIN_LOSS_REL_TOL or not all(r <= TRAIN_GRAD_REL_TOL for r in rel_grads.values()):
        raise RuntimeError("the kernel path's loss or gradients differ from the plain path's beyond their limits")
    if held["calls"] != TRAIN_LAUNCHES_PER_MICRO_STEP["flash_attention_backward"] or not held["ok"]:
        raise RuntimeError(f"call-by-call backward check failed: {held}")
    if held["layer_norm"]["calls"] != TRAIN_LAUNCHES_PER_MICRO_STEP["layer_norm"]:
        raise RuntimeError(f"call-by-call check: {held['layer_norm']['calls']} K6 calls in the micro-step, predicted "
                           f"{TRAIN_LAUNCHES_PER_MICRO_STEP['layer_norm']}")

    faults = {}
    for fname, fault in planted_backward_faults().items():
        with patched(fault):
            f_held = held_micro_step()
        faults[fname] = dict(held=f_held, caught=not f_held["ok"])
        log(f"[fault] {fname:24s} call by call: {show(f_held)} -> "
            f"{'caught' if faults[fname]['caught'] else 'not caught'}")
        if not faults[fname]["caught"]:
            raise RuntimeError(f"planted backward fault {fname} was not caught")
    shutil.rmtree(run_dir, ignore_errors=True)
    return dict(model=cfg.model_id, stage="align", per_device_batch=per_device_batch, global_batch=global_batch,
                grad_accumulation_steps=strategy.grad_accumulation_steps, steps=max_steps, losses=losses,
                step_timings=step_timings, step_s=step_s, split=split, tokens_per_step=tokens,
                tokens_per_s=tokens / step_s, peak_memory_gib=peak_gib, launches=counts,
                launches_per_micro_step=per_micro, loss_rel_diff=rel_loss, grad_rel_diff=rel_grads,
                held_call_by_call=held, planted_faults=faults, profile=profile)


# ---------------------------------------------------------------------------
# phase 5b: the pretrain entry point (cli/pretrain.py), align then finetune then a resume
# ---------------------------------------------------------------------------

PRETRAIN_ROOT = os.path.join("runs", "chip_smoke_pretrain")  # the dataset and the three run directories
PRETRAIN_SEED = 7  # the CLI's default seed (set_global_seed takes seeds > 0)
# merv-full (its arch takes the align projectors into finetune: merv-base's "no-align" skips the hand-off in both
# packages) with SigLIP ViT-B/16 swapped for the pooled so400m (so400m's all-tokens ids raise NotImplementedError in
# both packages), Llama-2-7B at full width; the recipe's per-device batches (align 16, finetune 8) over two steps
PRETRAIN_MODEL_ARGS = [
    "--model.type", "merv-full", "--model.model_id", "merv-full-so400m",
    "--model.video_backbone_ids",
    "[languagebind-video-noclass,dinov2-video-all-tokens,vivit-google-b-all-no-cls-16frames,siglip-vit-so400m]",
    "--model.align_max_steps", "2", "--model.align_global_batch_size", "32",
    "--model.finetune_max_steps", "2", "--model.finetune_global_batch_size", "16",
]
PRETRAIN_RUN_ARGS = ["--save_checkpoint_after", "1", "--trackers", "[jsonl]"]
PRETRAIN_FINETUNE_LLM_LAYERS = 1  # full finetune at 7B needs ~108 GB for params, grads and AdamW: one card holds 1 layer's
# kernel launches a micro-step under MERV_TPU_FUSED_VIT_BLOCK=1 (the counts of the configs): B6 at head dim 64 on
# LanguageBind's and DINOv2's 23 run layers (the penultimate tap) and ViViT's 12, at 72 on so400m's 27 (all, for the
# MAP head); K6 on the norms B6 leaves in those four towers; K2 twice a decoder layer (the forward and its recompute
# under remat), K3 once
PRETRAIN_TOWER_LAUNCHES = {"fused_vit_attn_block": 23 + 23 + 12, "fused_vit_attn_block_d72": 27,
                           "layer_norm": sum(TOWER_NORMS[t][1] for t in (
                               "languagebind-video-noclass", "dinov2-video-all-tokens",
                               "vivit-google-b-all-no-cls-16frames", "siglip-vit-so400m"))}
PRETRAIN_LLM_LAYERS = 32
PRETRAIN_DEVICE_ARGS = []  # the card (the CLI's default)
PRETRAIN_D72_TOWER = "siglip-vit-so400m"  # the tower whose layers B6 runs at head dim 72
# the first micro-step on the card (NVIDIA H100 80GB HBM3, 700 W), against the same micro-batch and weights with the
# switch off. The loss, relative: with B6 2.8e-5 to 6.0e-5 in every run, with the planted scale of head dim 64 at
# so400m's layers 1.65e-4 in the align run; the limit sits between. In the finetune runs (one LLM layer) the loss
# hardly depends on the towers at random init: the fault reads 6e-6 to 1.1e-5, below B6's own, so there the fault
# is left to so400m's output. That output, relative L2: with B6 5.1e-3, with the fault 1.8e-2 (EMBEDS_REL_TOL, 2e-2,
# would pass it); the limit sits between (PERF.md, section 6)
PRETRAIN_LOSS_REL_TOL = 1e-4
PRETRAIN_TOWER_REL_L2 = 1e-2


def pretrain_launches(llm_layers: int, micro_steps: int) -> dict:
    """Every counter's launches for ``micro_steps`` micro-steps of the pretrain phase's model."""
    import merv_tpu_torch.ops.attention as A

    per = dict(PRETRAIN_TOWER_LAUNCHES, flash_attention_forward=2 * llm_layers, flash_attention_backward=llm_layers)
    return {k: per.get(k, 0) * micro_steps for k in A.launch_counts()}


def bits_digest(module) -> dict:
    """{top-level child: a digest of its parameters' bits} (two int64 sums of
    each tensor's raw integers, one weighted by position), computed on the
    device: any changed bit changes it, so "unchanged" needs no host copy of a
    7B model."""
    import torch

    out = {}
    for key, child in module.named_children():
        total = torch.zeros(2, dtype=torch.int64, device=next(module.parameters()).device)
        for p in child.parameters():
            flat = p.detach().reshape(-1)
            ints = flat.view(torch.int32 if flat.element_size() == 4 else torch.int16)
            for i in range(0, ints.numel(), 1 << 24):
                part = ints[i:i + (1 << 24)].to(torch.int64)
                pos = torch.arange(i, i + part.numel(), device=part.device) % 8191 + 1
                total += torch.stack([part.sum(), (part * pos).sum()])
        out[key] = tuple(total.tolist())
    return out


def write_pretrain_dataset(root: str, seed: int, n_align: int, n_finetune: int) -> dict:
    """The align stage's annotation JSON (a caption a video) and the finetune
    stage's chat JSON (two rounds of questions and answers a video), their
    video entries on copies of the demo video under ``media/``."""
    import numpy as np

    media = os.path.join(root, "media")
    os.makedirs(media, exist_ok=True)
    clips = [f"clip{i}.mp4" for i in range(4)]
    for c in clips:
        shutil.copyfile(DEMO_VIDEO, os.path.join(media, c))
    rng = np.random.default_rng(seed)

    def words(lo, hi):
        return " ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))

    align = [{"video": clips[i % 4], "conversations": [{"from": "human", "value": "<video>\nDescribe the video."},
                                                        {"from": "gpt", "value": words(20, 61)}]}
             for i in range(n_align)]
    chat = [{"video": clips[i % 4], "conversations": [
        {"from": "human", "value": "<video>\nWhat happens first?"}, {"from": "gpt", "value": words(10, 40)},
        {"from": "human", "value": "And then?"}, {"from": "gpt", "value": words(10, 40)}]} for i in range(n_finetune)]
    for name, rows in (("align.json", align), ("chat.json", chat)):
        with open(os.path.join(root, name), "w") as f:
            json.dump(rows, f)
    return dict(align=len(align), finetune=len(chat), clips=len(clips))


def hold_fused_by_rows(args, out, stages, rows: int | None = None) -> dict:
    """``hold_fused`` on slices of ``rows`` of x's batch rows (by default as
    many as keep the plain version's fp32 scores of a slice within 1 GiB).
    Each row's attention is its own, so each slice is a hold of its own: ok
    only if every slice's is; each share the largest of any slice's."""
    x, heads = args[0], args[12]
    B, S = x.shape[:2]
    rows = rows or max(1, 2**30 // (heads * S * S * 4))
    parts = [hold_fused((x[i:i + rows],) + tuple(args[1:]), out[i:i + rows],
                        {k: v[i:i + rows] for k, v in stages.items()}) for i in range(0, B, rows)]
    merged = {k: dict(worst_share_of_limit=max(p["stages"][k]["worst_share_of_limit"] for p in parts),
                      mean_share=max(p["stages"][k]["mean_share"] for p in parts),
                      ok=all(p["stages"][k]["ok"] for p in parts)) for k in parts[0]["stages"]}
    return dict(ok=all(p["ok"] for p in parts), worst_share_of_limit=max(p["worst_share_of_limit"] for p in parts),
                mean_share=max(p["mean_share"] for p in parts), stages=merged, slices=len(parts))


def hold_path_b6(captured: dict, label: str) -> dict:
    """B6 held at the shapes a pretrain run gave it: for each (x's shape,
    heads) of its first micro-step, the first call's inputs (captured as the
    run went) launched once more through ``fused_vit_attn_block_stages``
    after the run's counts were read, held end to end (on the output the run
    itself got) and stage by stage by ``hold_fused_by_rows``, and B6's
    planted faults tried there (the scale of head dim 64 at 72; LayerScale's
    gamma taken as 1 where a tower has one): whether each is caught is
    recorded, and ``pretrain_final_checks`` fails the phase on a miss."""
    import torch

    import merv_tpu_torch.ops.fused_vit_block as TF

    faults, out = planted_tower_faults(), {}
    for (shape, heads), (args, path_out) in captured.items():
        hd = shape[-1] // heads
        name = f"{TF.launch_counter(hd)}/{label} {list(shape)} H{heads}"
        got, stages = TF.fused_vit_attn_block_stages(*args)
        held = hold_fused_by_rows(args, path_out, stages)
        rec = dict(shape=list(shape), heads=heads, head_dim=hd, slices=held["slices"], stages=held["stages"],
                   relaunch_same_bits=bool(torch.equal(got, path_out)))
        del got
        log(f"[pretrain] B6 held at the path's shape {name} ({held['slices']} slices; the relaunch's output bit-equal "
            f"to the run's: {rec['relaunch_same_bits']}), by stage, worst/limit: {stage_text(held)}")
        if not held["ok"]:
            raise RuntimeError(f"{name}: a stage is outside its limit on the path's inputs: {held['stages']}")
        names = ("b6_q_bias_dropped", "b6_scores_unscaled") + (
            ("b6_scale_of_head_dim_64",) if hd != 64 else ()) + (
            ("b6_gamma_ignored",) if not bool((args[11] == 1).all()) else ())
        for fault in names:
            with patched(faults[fault]):
                h = hold_fused_by_rows(args, path_out, stages)
            log(f"[fault] {fault:24s} {name}: worst/limit {h['worst_share_of_limit']:.2f} "
                f"({stage_text(h)}) -> {'not caught' if h['ok'] else 'caught'}")
            rec.setdefault("faults", {})[fault] = dict(worst_share_of_limit=h["worst_share_of_limit"], caught=not h["ok"])
        out[f"{list(shape)} H{heads}"] = rec
        del stages
    return out


def pretrain_run(stage: str, run_id: str, extra: list, records: list, held_shapes: set) -> tuple:
    """One ``pretrain()`` in this process under MERV_TPU_FUSED_VIT_BLOCK=1,
    with the launch counters set to 0 just before its training loop and read
    just after, the parameters' digests before and after it, its steps' split
    and losses. During its first micro-step it keeps that micro-batch and the
    inputs and output of B6's first call at each shape it has not held yet
    (nothing launched for that). After the counts were read: B6 held at those
    shapes (``hold_path_b6``), and, with the trainable weights set back to
    their start, the kept micro-batch's loss with the switch off and with a
    planted fault (the plain version with the scale of head dim 64 at
    so400m's head dim 72), then the trained weights restored."""
    import torch

    import merv_tpu_torch.ops.attention as A
    import merv_tpu_torch.ops.fused_vit_block as TF
    import merv_tpu_torch.training.checkpointing as ckpt
    import merv_tpu_torch.training.strategies.base_strategy as BS
    from merv_tpu_torch.cli.pretrain import pretrain

    rec = dict(stage=stage, run_id=run_id)
    records.append(rec)
    run_training, make_loss_fn, b6 = BS.TrainingStrategy.run_training, BS.make_loss_fn, TF.fused_vit_attn_block
    first, captured = {}, {}

    def capturing_b6(*a):
        y = b6(*a)
        key = (tuple(a[0].shape), a[12])
        if "batch" in first and not first.get("done") and key not in held_shapes and key not in captured:
            captured[key] = ((a[0].detach().clone(),) + tuple(t.detach() for t in a[1:12]) + tuple(a[12:]),
                             y.detach().clone())
        return y

    def checked_make_loss_fn(model, **kw):
        fn = make_loss_fn(model, **kw)

        def loss_fn(batch, timings=None):
            if "batch" not in first:
                first.update(batch=batch, fn=fn, transforms=kw["video_transforms"])
            loss = fn(batch, timings)
            if "loss" not in first:
                first.update(loss=loss.detach(), done=True)
            return loss

        return loss_fn

    def traced_run_training(self, dataset, collator, metrics, **kw):
        rec["digest_before"] = bits_digest(self.vidlm)
        rec["resume_step"] = self._resume_step
        trainable = [p for p in self.vidlm.parameters() if p.requires_grad]
        start = [p.detach().clone() for p in trainable]
        saves = len(ckpt.ASYNC_SAVES)
        timings = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()
        t = time.perf_counter()
        run_training(self, dataset, collator, metrics, step_timings=timings, **kw)
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t
        rec["launches"] = A.launch_counts()
        rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["digest_after"] = bits_digest(self.vidlm)
        rec["step_timings"], rec["async_saves"] = timings, ckpt.ASYNC_SAVES[saves:]
        rec["grad_accumulation_steps"] = self.grad_accumulation_steps
        # past the counted window: what follows launches kernels the counts above do not see
        rec["b6_held_at_path_shapes"] = hold_path_b6(captured, stage)
        held_shapes.update(captured)
        captured.clear()
        faults = planted_tower_faults()

        def scale_fault_b6(*a):  # the plain version with head dim 64's scale at head dim 72; the kernel elsewhere
            if a[0].shape[-1] // a[12] != 72:
                return b6(*a)
            with patched(faults["b6_scale_of_head_dim_64"]):
                return TF.fused_vit_attn_block_plain(*a)

        final = [p.detach().clone() for p in trainable]

        def route(name):  # the switch off, on, or on with the planted fault in place of B6 at head dim 72
            stack = contextlib.ExitStack()
            stack.enter_context(switches({} if name == "switch_off" else {"MERV_TPU_FUSED_VIT_BLOCK": "1"}))
            if name == "planted_scale_of_head_dim_64":
                stack.enter_context(patched((TF, "fused_vit_attn_block", scale_fault_b6)))
            return stack

        with torch.no_grad():
            for p, s in zip(trainable, start):
                p.copy_(s)
            del start
            loss = {}
            for name in ("switch_off", "planted_scale_of_head_dim_64"):
                with route(name):
                    loss[name] = first["fn"](first["batch"]).item()
            for p, f in zip(trainable, final):
                p.copy_(f)
            del final
            # so400m's output on the same micro-batch: the tower B6 changes, before the projectors and the LLM
            i, vb = next((i, vb) for i, vb in enumerate(self.vidlm.video_backbones)
                         if vb.identifier == PRETRAIN_D72_TOWER)
            video = first["transforms"][i].device_finish(first["batch"]["video_values"][i])
            feats = {}
            for name in ("switch_on", "switch_off", "planted_scale_of_head_dim_64"):
                with route(name):
                    feats[name] = vb(video).float()
        rec["first_micro_step_loss"] = dict(switch_on=first["loss"].item(), **loss)
        rec["so400m_rel_l2"] = {name: rel_l2(feats[name], feats["switch_off"])
                                for name in ("switch_on", "planted_scale_of_head_dim_64")}
        del feats, video
        first.clear()

    argv = (PRETRAIN_MODEL_ARGS + ["--dataset.dataset_root_dir", PRETRAIN_ROOT,
                                   "--dataset.align_stage_components", "[align.json,media]",
                                   "--dataset.finetune_stage_components", "[chat.json,media]", "--stage", stage,
                                   "--run_id", run_id, "--run_root_dir", os.path.join(PRETRAIN_ROOT, "runs"),
                                   "--seed", str(PRETRAIN_SEED)] + PRETRAIN_RUN_ARGS + PRETRAIN_DEVICE_ARGS + extra)
    rec["argv"] = argv
    t = time.perf_counter()
    with switches({"MERV_TPU_FUSED_VIT_BLOCK": "1"}), patched(
            (BS.TrainingStrategy, "run_training", traced_run_training), (BS, "make_loss_fn", checked_make_loss_fn),
            (TF, "fused_vit_attn_block", capturing_b6)):
        strategy = pretrain(args=argv)
    rec["process_s"] = time.perf_counter() - t
    rec["run_dir"] = os.path.join(PRETRAIN_ROOT, "runs", run_id)
    key = "Align" if stage.endswith("align") else "Finetune"
    rec["logged_steps"] = [json.loads(x)[f"{key}/Step"] for x in open(os.path.join(rec["run_dir"], f"{run_id}.jsonl"))]
    return rec, strategy


def pretrain_checks(rec: dict, predicted: dict, trainable: tuple, frozen: tuple) -> None:
    """The run's checks: launches as predicted, finite losses, the frozen
    modules' bits unchanged and the trainable ones moved, and
    ``latest-checkpoint`` on a directory with its meta.json. The first
    micro-step's loss with the switch on and off, and with the planted scale
    fault, are held by ``pretrain_final_checks``."""
    from merv_tpu_torch.training.checkpointing import latest_checkpoint

    label = f"pretrain {rec['stage']} ({rec['run_id']})"
    if rec["launches"] != predicted:
        raise RuntimeError(f"{label}: launches {rec['launches']}, predicted {predicted}")
    losses = [st["loss"] for st in rec["step_timings"]]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{label}: losses {losses}")
    before, after = rec["digest_before"], rec["digest_after"]
    if [k for k in frozen if before[k] != after[k]]:
        raise RuntimeError(f"{label}: frozen modules changed: {[k for k in frozen if before[k] != after[k]]}")
    if [k for k in trainable if before[k] == after[k]]:
        raise RuntimeError(f"{label}: trainable modules did not move: {[k for k in trainable if before[k] == after[k]]}")
    first = rec["first_micro_step_loss"]
    rec["first_micro_step_rel_diff"] = abs(first["switch_on"] - first["switch_off"]) / abs(first["switch_off"])
    rec["planted_fault_rel_diff"] = (abs(first["planted_scale_of_head_dim_64"] - first["switch_off"])
                                     / abs(first["switch_off"]))
    latest = latest_checkpoint(rec["run_dir"])
    if latest is None or not os.path.exists(os.path.join(latest, "meta.json")):
        raise RuntimeError(f"{label}: latest-checkpoint {latest} has no meta.json")
    rec["latest_checkpoint"] = os.path.basename(latest)


def pretrain_final_checks(records: list) -> None:
    """Run once every run's readings were logged. B6's planted faults were
    caught at every shape of the path (``hold_path_b6``); each run's first
    micro-step's loss with B6 is within PRETRAIN_LOSS_REL_TOL of the
    switch-off loss, and the align run's (the LLM at full depth) with the
    planted scale fault outside it; so400m's output with B6 is within
    PRETRAIN_TOWER_REL_L2 of the switch-off route's in every run, the planted
    fault's outside it (so that each limit can fail a wrong kernel)."""
    missed = [f"{f} at {shape} ({r['stage']})" for r in records for shape, h in r["b6_held_at_path_shapes"].items()
              for f, v in h.get("faults", {}).items() if not v["caught"]]
    loss = [f"{r['stage']} ({r['run_id']}): with B6 {r['first_micro_step_rel_diff']:.3e}, planted fault "
            f"{r['planted_fault_rel_diff']:.3e}" for r in records
            if not r["first_micro_step_rel_diff"] <= PRETRAIN_LOSS_REL_TOL
            or (r["stage"] == "align" and not r["planted_fault_rel_diff"] > PRETRAIN_LOSS_REL_TOL)]
    tower = [f"{r['stage']} ({r['run_id']}): {r['so400m_rel_l2']}" for r in records if not
             r["so400m_rel_l2"]["switch_on"] <= PRETRAIN_TOWER_REL_L2 < r["so400m_rel_l2"]["planted_scale_of_head_dim_64"]]
    if missed or loss or tower:
        raise RuntimeError(f"B6's planted faults not caught on the path's inputs: {missed}; the first micro-step's "
                           f"loss against the switch-off loss, limit {PRETRAIN_LOSS_REL_TOL} (B6 within it, the "
                           f"planted fault outside in the align run): {loss}; so400m's output against the switch-off "
                           f"route's, limit {PRETRAIN_TOWER_REL_L2} (B6 within it, the planted fault outside): {tower}")


def dataset_video_patches(seed: int) -> tuple:
    """(the backend that opens the demo video or "synthetic", what each backend
    gave, the patches under which the datasets read its copies): where no
    decoder opens it, seeded frames of its decoded shape."""
    _, frames_from, decoders = demo_video(seed)
    if frames_from != "synthetic":
        return frames_from, decoders, []
    import numpy as np

    import merv_tpu_torch.preprocessing.datasets.datasets as DS

    frames = np.random.default_rng(seed + 3).integers(0, 256, size=SYNTHETIC_FRAMES, dtype=np.uint8)
    return frames_from, decoders, [(DS, "load_video", lambda path, num_frames=8, **kw: frames[:num_frames])]


def pretrain_path(dev, seed: int) -> dict:
    """Phase 5b: ``cli/pretrain.py``'s ``pretrain()`` in process under
    MERV_TPU_FUSED_VIT_BLOCK=1 on a dataset written to ``PRETRAIN_ROOT``:
    align (merv-full with the pooled so400m, Llama-2-7B at full width and
    depth, 2 steps at per-device batch 16, accumulation 2, a checkpoint every
    step, written async), finetune (the align checkpoint discovered beside it,
    the LLM cut to PRETRAIN_FINETUNE_LLM_LAYERS at full width, 2 steps at
    per-device batch 8, accumulation 2), then the finetune resumed from its
    step-1 checkpoint (the consumed batch skipped). Checks of ``pretrain_checks``
    on each, B6 held at each shape it met (``hold_path_b6``), and
    ``pretrain_final_checks`` once every run's readings are logged; the align
    projectors are the finetune's start; the resume trains step 2 alone."""
    import dataclasses
    import gc
    import multiprocessing

    import torch

    import merv_tpu_torch.models.backbones.llm.base_llm as base_llm
    from merv_tpu_torch.training.checkpointing import latest_checkpoint

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shutil.rmtree(PRETRAIN_ROOT, ignore_errors=True)
    os.makedirs(PRETRAIN_ROOT)
    for name in ("MERV_TPU_TOWER_DIR", "MERV_TPU_LLM_DIR"):
        os.environ.pop(name, None)
    out = dict(dataset=write_pretrain_dataset(PRETRAIN_ROOT, seed, n_align=64, n_finetune=32),
               disk_free_gib=shutil.disk_usage(PRETRAIN_ROOT).free / 2**30)
    frames_from, decoders, synthetic = dataset_video_patches(seed)
    out["frames_from"] = frames_from
    log(f"[pretrain] dataset {out['dataset']} at {PRETRAIN_ROOT}; frames from {frames_from} ({decoders}); "
        f"{out['disk_free_gib']:.1f} GiB free on its disk")
    records, held_shapes = [], set()
    tag = f"x{PRETRAIN_SEED}"
    align_id, ft_id = f"merv-full-so400m+7b+stage-align+{tag}", f"merv-full-so400m+7b+stage-finetune+{tag}"
    spec = base_llm.LLM_SPECS["llama2-7b-pure"]
    reduced = dataclasses.replace(spec, decoder_config=dataclasses.replace(spec.decoder_config,
                                                                           num_layers=PRETRAIN_FINETUNE_LLM_LAYERS))
    try:
        with patched(*synthetic):
            align, strategy = pretrain_run("align", align_id, [], records, held_shapes)
            micro = align["grad_accumulation_steps"] * len(align["step_timings"])
            pretrain_checks(align, pretrain_launches(PRETRAIN_LLM_LAYERS, micro), ("projectors", "feature_fusion"),
                            ("video_backbones", "llm_backbone"))
            del strategy
            gc.collect()
            torch.cuda.empty_cache()
            with patched((base_llm, "LLM_SPECS", dict(base_llm.LLM_SPECS, **{"llama2-7b-pure": reduced}))):
                ft, strategy = pretrain_run("finetune", ft_id, [], records, held_shapes)
                micro = ft["grad_accumulation_steps"] * len(ft["step_timings"])
                pretrain_checks(ft, pretrain_launches(PRETRAIN_FINETUNE_LLM_LAYERS, micro),
                                ("projectors", "llm_backbone"), ("video_backbones",))
                if ft["digest_before"]["projectors"] != align["digest_after"]["projectors"]:
                    raise RuntimeError("finetune did not start from the align run's trained projectors")
                final = {k: v for k, v in ft["digest_after"].items()}
                del strategy
                gc.collect()
                torch.cuda.empty_cache()
                ckpts = os.path.join(PRETRAIN_ROOT, "runs", ft_id, "checkpoints")
                step1 = next(os.path.join(ckpts, d) for d in sorted(os.listdir(ckpts)) if d.startswith("step-000001-"))
                for d in os.listdir(ckpts):  # the straight run's step-2 checkpoints: disk the resume does not need
                    if d.startswith("step-000002-") or d == "latest-checkpoint":
                        path = os.path.join(ckpts, d)
                        os.unlink(path) if os.path.islink(path) else shutil.rmtree(path)
                res, strategy = pretrain_run(
                    "finetune", f"merv-full-so400m+7b-resumed+stage-finetune+{tag}",
                    ["--pretrained_checkpoint", str(latest_checkpoint(os.path.join(PRETRAIN_ROOT, "runs", align_id))),
                     "--resume_from_checkpoint", step1], records, held_shapes)
                micro = res["grad_accumulation_steps"] * len(res["step_timings"])
                pretrain_checks(res, pretrain_launches(PRETRAIN_FINETUNE_LLM_LAYERS, micro),
                                ("projectors", "llm_backbone"), ("video_backbones",))
                if res["resume_step"] != 1 or res["logged_steps"] != [2] or ft["logged_steps"] != [1, 2]:
                    raise RuntimeError(f"resume: from step {res['resume_step']}, logged {res['logged_steps']} "
                                       f"(straight {ft['logged_steps']})")
                # the resume ends where the straight run did: not bit for bit (the card's kernels' sums may take
                # other orders across runs), so the digests are reported, not gated
                res["same_bits_as_straight_run"] = {k: res["digest_after"][k] == final[k] for k in final}
                del strategy
        if multiprocessing.active_children():
            raise RuntimeError(f"processes left running: {multiprocessing.active_children()}")
    finally:
        shutil.rmtree(PRETRAIN_ROOT, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    for rec in records:
        for k in ("digest_before", "digest_after"):
            rec.pop(k, None)
        st = rec["step_timings"]
        rec["step_s"] = [x["step_s"] for x in st]
        rec["micro_step_s"] = [x["step_s"] / rec["grad_accumulation_steps"] for x in st]
        rec["losses"] = [x["loss"] for x in st]
        log(f"[pretrain] {rec['stage']} {rec['run_id']}: pretrain() {rec['process_s']:.1f} s, training loop "
            f"{rec['wall_s']:.1f} s; steps {[round(x, 3) for x in rec['step_s']]} s (micro-steps "
            f"{[round(x, 3) for x in rec['micro_step_s']]} s; split " +
            "; ".join(f"towers {x['towers_s']:.3f} LLM {x['llm_s']:.3f} optimizer {x['optimizer_s']:.3f}" for x in st)
            + f"); losses {rec['losses']}; first micro-step loss with B6 / switch off / planted fault "
            f"{rec['first_micro_step_loss']} (relative: B6 {rec['first_micro_step_rel_diff']:.2e}, planted fault "
            f"{rec['planted_fault_rel_diff']:.2e}; limit {PRETRAIN_LOSS_REL_TOL}); so400m's output against the switch "
            f"off, relative L2: {rec['so400m_rel_l2']} (limit {PRETRAIN_TOWER_REL_L2}); "
            f"launches {rec['launches']}; peak {rec['peak_memory_gib']:.2f} GiB; async saves "
            + "; ".join(f"{a['checkpoint']} copy {a['copy_s']:.3f} s write {a.get('write_s', 0):.3f} s waited "
                        f"{a.get('waited_s', 0):.3f} s" for a in rec["async_saves"])
            + f"; latest {rec['latest_checkpoint']}; steps logged {rec['logged_steps']}")
    out.update(align=records[0], finetune=records[1], resume=records[2], wall_s=time.perf_counter() - t0)
    log(f"[pretrain] phase 5b: {out['wall_s']:.1f} s; the resume's bits equal the straight run's: "
        f"{records[2]['same_bits_as_straight_run']}")
    pretrain_final_checks(records)
    return out

# ---------------------------------------------------------------------------
# phase 5c: multi-rank training (two ranks on the card over gloo), against world 1 in this process
# ---------------------------------------------------------------------------

TP_RANKS = 2
TP_ROOT = os.path.join("runs", "chip_smoke_train_parallel")
# Llama-2-7B at full width (hidden 4,096, 32 heads), its depth cut because two ranks and this process's world-1
# reference share the one card: 2 layers for the finetune runs (the pipeline puts one on each stage), 4 for align
TP_FINETUNE_LAYERS = 2
TP_ALIGN_LAYERS = 4
# the global batch: one micro-batch in the finetune runs (world 1 and a pp rank 8 rows, an fsdp rank 4: FSDP2 gathers
# and reduce-scatters once a step), two in the align runs (world 1 and an sp rank 4 rows a micro-step)
TP_GLOBAL_BATCH = 8
TP_TEXT_TOKENS = 256  # + merv-base's 1,024 visual tokens = 1,280, a multiple of 2 sp = 4 (the zigzag ring)
TP_PADS = (0, 37, 5, 120, 0, 64, 11, 200)  # each row's right padding: the data ranks hold unequal label counts
# step 1 on two ranks against the same global batch and init at world 1 (this process), relative: the loss and the
# global norm before the clip; the projectors' and fusion's gradients on one micro-batch under sp = 2, relative L2.
# Each limit sits between what the runs read and what a planted fault reads on the same step (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md, section 6). The loss: fsdp 8.5e-8, pp 0 (the same kernels on the same rows; only fp32 sums reorder),
# each data rank's own token mean averaged 5.3e-5 to 7.8e-5 (at random init every token's loss is near ln 32,000, so
# that fault moves the loss little). The norm: fsdp 2.3e-6 to 4.0e-6, pp 3.4e-6 to 5.4e-6, one rank's shards alone
# 0.29. The gradients: the
# projectors 1.3e-2, the fusion 5.1e-3 (bf16 ring blocks merged in fp32, against whole-sequence K2), a gather
# backward that sums the ranks' gradients 1.0
TP_LOSS_REL_TOL = 5e-6
TP_NORM_REL_TOL = 1e-4
TP_GRAD_REL_TOL = 5e-2
# step 2 against world 1's step 2, relative: after one AdamW step, whose update lr * m / sqrt(v) is about lr a weight
# whatever the gradient's size, the runs part where a gradient near 0 takes the other sign: fsdp read 6.6e-7 (loss)
# and 3.7e-5 (norm), pp 2.8e-5 and 5.3e-6, where a lost step-1 update moves the loss by 1e-1
TP_STEP2_REL_TOL = 1e-3
# (b)'s step-1 checkpoint, written by the two ranks, against world 1's state after its step 1 (relative L2 over all
# tensors of a kind): the trainables part only where an update's sign flips (a whole step is lr 2e-5 against weights
# of std 2e-2, 1e-3 of them), read 6.8e-7; the AdamW moments (0.1 g and 1e-3 g^2) part as the gradients do, within
# TP_GRAD_REL_TOL, read 2.3e-3 and 4.3e-3; a gather that puts the ranks' shards in the other order, or moments under
# other indices, read 1.17 to 1.42
TP_PARAM_REL_TOL = 1e-3
# (c) runs cli/pretrain.py: merv-base's align stage on TP_ROOT's dataset, its text cut to TP_TEXT_TOKENS (the
# collator pads every row to it), 2 steps at per-device batch 4, a checkpoint every step (async, from rank 0)
TP_CLI_ARGS = ["--model.type", "merv-base", "--model.llm_max_length", str(TP_TEXT_TOKENS),
               "--model.align_max_steps", "2", "--model.align_global_batch_size", str(TP_GLOBAL_BATCH),
               "--model.align_per_device_batch_size", "4", "--dataset.dataset_root_dir", TP_ROOT,
               "--dataset.align_stage_components", "[align.json,media]", "--stage", "align",
               "--run_root_dir", os.path.join(TP_ROOT, "runs"), "--save_checkpoint_after", "1",
               "--trackers", "[jsonl]"]


def tp_model(dev, seed: int, stage: str, layers: int, **parallel):
    """merv-base from the registry's factories on random weights from ``seed``
    (as ``cli/pretrain.py`` builds it, so every rank starts from the same
    bits), Llama-2-7B cut to ``layers``, frozen for ``stage``."""
    import dataclasses

    import merv_tpu_torch.models.backbones.llm.base_llm as base_llm
    from merv_tpu_torch.conf import MERV_Base
    from merv_tpu_torch.device import make_generator
    from merv_tpu_torch.models import materialize as MZ

    cfg = MERV_Base()
    g = make_generator(dev, seed)
    towers, transforms = MZ.get_video_backbone_and_transform(cfg.video_backbone_ids, cfg.image_resize_strategy,
                                                             cfg.num_frames, device=dev, generator=g)
    spec = base_llm.LLM_SPECS[cfg.llm_backbone_id]
    spec = dataclasses.replace(spec, decoder_config=dataclasses.replace(spec.decoder_config, num_layers=layers))
    with patched((base_llm, "LLM_SPECS", dict(base_llm.LLM_SPECS, **{cfg.llm_backbone_id: spec}))):
        llm, _ = MZ.get_llm_backbone_and_tokenizer(cfg.llm_backbone_id, llm_max_length=cfg.llm_max_length,
                                                   device=dev, generator=g, **parallel)
    vidlm = MZ.get_vidlm(cfg.model_id, cfg.arch_specifier, cfg.feature_fusion, towers, llm,
                         projector_token_length=cfg.projector_token_length,
                         visual_feature_length=cfg.visual_feature_length, device=dev, generator=g)
    vidlm.freeze_backbones(stage)
    return cfg, vidlm, transforms


def tp_batch(dev, vidlm, transforms, seed: int) -> dict:
    """The global batch, the same on every process: uint8 frames at each
    tower's host geometry, TP_TEXT_TOKENS text tokens (ids below 32,000, the
    tokenizer's) right-padded by TP_PADS."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 11)
    B, T = TP_GLOBAL_BATCH, TP_TEXT_TOKENS
    ids = rng.integers(3, min(32000, vidlm.llm_backbone.decoder.cfg.vocab_size), size=(B, T))
    ids[:, 0] = 1
    mask = np.ones((B, T), np.int64)
    for b, pad in enumerate(TP_PADS):
        if pad:
            ids[b, T - pad:], mask[b, T - pad:] = 0, 0
    labels = np.where(mask == 1, ids, -100)
    labels[:, 0] = -100
    videos = [torch.from_numpy(rng.integers(0, 256, size=(B, vb.num_frames, tf.target_size, tf.target_size, 3),
                                            dtype=np.uint8)).to(dev) for vb, tf in zip(vidlm.video_backbones, transforms)]
    return dict(input_ids=torch.from_numpy(ids).to(dev), attention_mask=torch.from_numpy(mask).to(dev),
                labels=torch.from_numpy(labels).to(dev), is_multimodal=torch.ones(B, dtype=torch.bool, device=dev),
                video_values=videos)


def tp_rows(batch: dict, accum: int, coord: int, ranks: int) -> dict:
    """A rank's part of the global batch: the rows of each of the ``accum``
    micro-batches at its batch coordinate (``merv_tpu``'s [accum, micro]
    layout, the micro-batch split over the batch ranks)."""
    import torch

    micro = TP_GLOBAL_BATCH // accum
    per = micro // ranks
    rows = torch.cat([torch.arange(i * micro + coord * per, i * micro + (coord + 1) * per) for i in range(accum)])

    def cut(x):
        return [cut(e) for e in x] if isinstance(x, list) else x[rows.to(x.device)]

    return {k: cut(v) for k, v in batch.items()}


def tp_strategy(name: str, vidlm, cfg, stage: str, per_device: int, mesh, transforms, run_dir: str):
    from merv_tpu_torch.training import get_train_strategy

    p = "align" if stage == "align" else "finetune"
    strategy = get_train_strategy(
        name, vidlm, stage=stage, max_steps=2, global_batch_size=TP_GLOBAL_BATCH, per_device_batch_size=per_device,
        learning_rate=getattr(cfg, f"{p}_learning_rate"), weight_decay=getattr(cfg, f"{p}_weight_decay"),
        max_grad_norm=getattr(cfg, f"{p}_max_grad_norm"), lr_scheduler_type="constant",
        enable_gradient_checkpointing=True, loss_chunk_size=TRAIN_LOSS_CHUNK, mesh=mesh)
    strategy.run_setup(run_dir, n_train_examples=TP_GLOBAL_BATCH, video_transforms=transforms)
    return strategy


def tp_local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def tp_bytes(vidlm, tx) -> dict:
    """The bytes this rank keeps: its parameters (its shards), their AdamW
    moments, and its decoder layers' parameters."""
    params = sum(tp_local(p).numel() * p.element_size() for p in vidlm.parameters())
    moments = sum(tp_local(v).numel() * v.element_size() for st in tx.adamw.state.values() for v in st.values()
                  if v.dim())
    layers = sum(tp_local(p).numel() * p.element_size() for n, p in vidlm.named_parameters()
                 if n.startswith("llm_backbone.decoder.layers."))
    return dict(params=params, optimizer=moments, params_and_optimizer=params + moments, llm_layers=layers)


def tp_hash(vidlm, names) -> str:
    """A digest of the named parameters' whole values (gathered where sharded: collective)."""
    from merv_tpu_torch.parallel.sharding import full_tensor

    h = hashlib.sha256()
    params = dict(vidlm.named_parameters())
    for n in names:
        t = full_tensor(params[n].detach()).float().cpu().contiguous()
        h.update(n.encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:16]


def tp_steps(strategy, batch, steps: int, record: dict) -> list:
    """``steps`` train steps of the strategy on this rank's batch: each step's
    loss and grad norm. ``record`` gets what the planted faults' readings are
    computed from, with no launch of their own: each step's norm of this
    rank's shards alone (``local_norms``), and each micro-step's label tokens
    on this rank and on the whole micro-batch and this rank's loss share
    (``micro_steps``)."""
    import torch

    import merv_tpu_torch.models.vidlms.merv as M

    tx, norm, count = strategy.tx, strategy.tx.global_norm, M.global_token_count
    record.setdefault("local_norms", [])
    micro = record.setdefault("micro_steps", [])

    def recorded_norm():
        grads = [tp_local(p.grad) for p in tx.params if p.grad is not None]
        record["local_norms"].append(torch.sqrt(sum(g.float().square().sum() for g in grads)).item())
        return norm()

    def counted(c):
        whole = count(c)
        micro.append(dict(tokens=int(c), whole=int(whole)))
        return whole

    def loss_seen(module, args, out):
        if out.get("loss") is not None and micro and "share" not in micro[-1]:
            micro[-1]["share"] = float(out["loss"].detach())

    hook = strategy.vidlm.register_forward_hook(loss_seen)
    out = []
    try:
        with patched((tx, "global_norm", recorded_norm), (M, "global_token_count", counted)):
            for _ in range(steps):
                m = strategy.step_fn(batch)
                out.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
    finally:
        hook.remove()
    return out


def tp_rank_mean_loss(ranks: list, step: int, accum: int) -> float:
    """The planted fault of the loss over data ranks: each rank's own token
    mean averaged over the ranks, in place of the mean over the whole
    micro-batch, from the ranks' recorded micro-steps of ``step`` (0-based)."""
    per = []
    for i in range(step * accum, (step + 1) * accum):
        ms = [r["record"]["micro_steps"][i] for r in ranks]
        per.append(sum(m["share"] * m["whole"] / m["tokens"] for m in ms) / len(ms))
    return sum(per) / len(per)


def gloo_probe(dev) -> dict:
    """Which collectives gloo takes on CUDA tensors on this card, each on a
    group of its own, with DDP's bucketed all-reduce. Not send / receive:
    gloo's send of a CUDA tensor aborts the process (an uncaught
    ``gloo::IoException`` in its I/O thread, on the H100 with torch 2.11); the port stages
    those through the host (the ring's shift, the pipeline's hand-off)."""
    import torch
    import torch.distributed as dist

    rank, n = dist.get_rank(), dist.get_world_size()
    x = torch.full((4, 8), float(rank + 1), device=dev)

    def ddp(group):
        m = torch.nn.Linear(16, 4, device=dev)
        torch.nn.parallel.DistributedDataParallel(m, process_group=group)(torch.randn(3, 16, device=dev)).sum().backward()

    cases = {
        "all_reduce": lambda g: dist.all_reduce(x.clone(), group=g),
        "broadcast": lambda g: dist.broadcast(x.clone(), src=n - 1, group=g),
        "all_gather": lambda g: dist.all_gather([torch.empty_like(x) for _ in range(n)], x, group=g),
        "all_gather_into_tensor": lambda g: dist.all_gather_into_tensor(torch.empty(n * 4, 8, device=dev), x, group=g),
        "reduce_scatter_tensor": lambda g: dist.reduce_scatter_tensor(torch.empty(4 // n, 8, device=dev), x, group=g),
        "ddp_buckets": ddp,
    }
    out = {"send_recv": "not probed (aborts the process); staged through the host"}
    for name, fn in cases.items():
        group = dist.new_group(backend="gloo")
        try:
            fn(group)
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except Exception as e:  # noqa: BLE001 -- what gloo refuses is the reading
            out[name] = f"refused: {type(e).__name__}: {str(e)[:120]}"
    return out


class RingRecorder:
    """Keeps this rank's first ring K2 call (with its LSE) and last K3 call of
    the counted window, inputs and outputs, for ``hold`` after the counts are
    read (as ``SpRecorder`` does for K5). The last K3 call is the first
    layer's: the backward's first calls are the last layer's, whose early
    rows (BOS and the visual tokens, ignored by the loss) get a zero gradient."""

    def __init__(self):
        self.k2 = self.k3 = None

    @contextlib.contextmanager
    def active(self):
        import merv_tpu_torch.ops.attention as A

        fwd, bwd = A.flash_attention_forward, A.flash_attention_backward
        keep = lambda t: t.detach().clone() if hasattr(t, "detach") else t  # noqa: E731

        def k2(q, k, v, **kw):
            out = fwd(q, k, v, **kw)
            if kw.get("return_lse") and q.shape[-1] == 128 and self.k2 is None:
                self.k2 = dict(args=tuple(keep(t) for t in (q, k, v)), kw=dict(kw), out=tuple(keep(t) for t in out))
            return out

        def k3(q, k, v, o, lse, do, **kw):
            out = bwd(q, k, v, o, lse, do, **kw)
            self.k3 = dict(args=tuple(keep(t) for t in (q, k, v, o, lse, do)), kw=dict(kw),
                           out=tuple(keep(t) for t in out))
            return out

        with patched((A, "flash_attention_forward", k2), (A, "flash_attention_backward", k3)):
            yield

    def holds(self) -> dict:
        import merv_tpu_torch.ops.attention as A

        out = {}
        if self.k2 is not None:
            q, k, v = self.k2["args"]
            kw = {key: val for key, val in self.k2["kw"].items() if key != "return_lse"}
            o_ref, lse_ref = A.flash_attention_forward_plain(q, k, v, return_lse=True, **kw)
            mag = A.flash_attention_forward_plain(q, k, v.abs(), **kw)
            h, hl = hold(self.k2["out"][0], o_ref, mag), hold_lse(self.k2["out"][1], lse_ref)
            out["k2"] = dict(q=list(q.shape), k=list(k.shape), causal=kw.get("causal"), ok=h["ok"] and hl["ok"],
                             worst_share_of_limit=h["worst_share_of_limit"], mean_share=h["mean_share"],
                             lse_worst_share_of_limit=hl["worst_share_of_limit"])
        if self.k3 is not None:
            q, k, v, o, lse, do = self.k3["args"]
            h = hold_backward(q, k, v, o, lse, do, self.k3["out"], **self.k3["kw"])
            out["k3"] = dict(q=list(q.shape), k=list(k.shape), causal=self.k3["kw"].get("causal"), ok=h["ok"],
                             worst_share_of_limit=h["worst_share_of_limit"], worst_mean_share=h["worst_mean_share"])
        self.k2 = self.k3 = None
        return out


def tp_grads(strategy, batch, rows: int, transforms) -> dict:
    """The trainables' gradients (whole, on the host) of one micro-batch (the
    first ``rows`` rows of ``batch``) at the current weights, through the
    strategy's own loss function and, on a mesh, its loss scale and sums."""
    import torch

    from merv_tpu_torch.parallel.sharding import activation_mesh, full_tensor
    from merv_tpu_torch.training.train_step import make_loss_fn, micro_batch

    sh = strategy.sharding
    module = strategy.vidlm if sh is None else sh.module
    loss_fn = make_loss_fn(module, remat=True, video_transforms=transforms, loss_chunk_size=TRAIN_LOSS_CHUNK)
    strategy.tx.zero_grad()
    mb = micro_batch(batch, 0, batch["labels"].shape[0] // rows)
    with (contextlib.nullcontext() if sh is None else activation_mesh(sh.mesh)):
        loss = loss_fn(mb)
        (loss * (1.0 if sh is None else sh.backward_scale)).backward()
    if sh is not None:
        sh.sync_grads(strategy.tx.params)
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad) for n, p in strategy.tx.named_params.items()}
    out = {n: full_tensor(g.detach()).float().cpu() for n, g in grads.items()}
    strategy.tx.zero_grad()
    return out


def tp_counts_reset():
    import torch

    import merv_tpu_torch.ops.attention as A
    import merv_tpu_torch.ops.ring_attention as R
    import merv_tpu_torch.parallel.pipeline as PP

    torch.cuda.synchronize()
    A.reset_launch_counts()
    R.reset_collective_counts()
    PP.reset_collective_counts()


def tp_counts() -> dict:
    import torch

    import merv_tpu_torch.ops.attention as A
    import merv_tpu_torch.ops.ring_attention as R
    import merv_tpu_torch.parallel.pipeline as PP

    torch.cuda.synchronize()
    return dict(launches={k: n for k, n in A.launch_counts().items() if n},
                collectives={**{k: n for k, n in R.COLLECTIVES.items() if n},
                             **{k: n for k, n in PP.COLLECTIVES.items() if n}})


def train_parallel_worker(out_dir: str, device_type: str = "cuda") -> int:
    """One rank of phase 5c, started by ``torch.distributed.run`` (``--train-parallel-worker``):
    (a) the gloo probe, (b) fsdp-full-shard finetune, (c) align at sp = 2
    through ``cli/pretrain.py``, (d) finetune at pp = 2, each on a fresh
    model; results to ``out_dir``."""
    import gc

    import torch

    from merv_tpu_torch.parallel import MeshConfig, build_mesh
    from merv_tpu_torch.parallel.mesh import batch_rank, batch_size, world

    rank = world()[0]
    dev = torch.device(device_type)
    res = {"rank": rank}
    # the process group starts here
    mesh = build_mesh(MeshConfig(data=1, fsdp=-1, tensor=1), device_type=device_type, backend="gloo")
    res["gloo_probe"] = gloo_probe(dev)
    log(f"[train-parallel rank {rank}] (a) probe done: {res['gloo_probe']}")

    def run(label, stage, layers, strategy_name, mesh, per_device, steps, **parallel):
        t = time.perf_counter()
        cfg, vidlm, transforms = tp_model(dev, TP_SEED, stage, layers, **parallel)
        run_dir = os.path.join(TP_ROOT, label)
        strategy = tp_strategy(strategy_name, vidlm, cfg, stage, per_device, mesh, transforms, run_dir)
        trainable = [n for n, t_ in vidlm.trainable_mask().items() if t_]
        batch = tp_rows(tp_batch(dev, vidlm, transforms, TP_SEED), strategy.grad_accumulation_steps,
                        batch_rank(mesh), batch_size(mesh))
        r = dict(label=label, layers=layers, world_size=strategy.world_size,
                 accum=strategy.grad_accumulation_steps, per_device=per_device, start_hash=tp_hash(vidlm, trainable),
                 counted_micro_steps=strategy.grad_accumulation_steps * steps, build_s=time.perf_counter() - t)
        return cfg, vidlm, strategy, batch, r, transforms

    # (b) fsdp-full-shard finetune, fsdp = 2
    cfg, vidlm, strategy, batch, r, _ = run("fsdp", "finetune", TP_FINETUNE_LAYERS, "fsdp-full-shard", mesh, 4, 1)
    log(f"[train-parallel rank {rank}] (b) built and sharded in {r['build_s']:.1f} s")
    r["record"] = {}
    tp_counts_reset()
    t = time.perf_counter()
    r["steps"] = tp_steps(strategy, batch, 1, r["record"])
    r.update(tp_counts(), wall_s=time.perf_counter() - t)  # step 1 counted; the checkpoint's gathers are not
    t = time.perf_counter()
    strategy.save_checkpoint(os.path.join(TP_ROOT, "fsdp"), 1, 0, r["steps"][0]["loss"])
    r["checkpoint_s"] = time.perf_counter() - t
    if rank == 0:  # the file is whole: the main process holds it and resumes it while (c) and (d) run
        open(os.path.join(out_dir, TP_SAVED_MARK), "w").close()
    r["steps"] += tp_steps(strategy, batch, 1, r["record"])
    r.update(bytes=tp_bytes(vidlm, strategy.tx), peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    res["fsdp"] = r
    log(f"[train-parallel rank {rank}] (b) done: {r['steps']}")
    del cfg, vidlm, strategy, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (c) align at --mesh_seq 2 through cli/pretrain.py: the ring in every decoder layer
    res["sp"] = r = tp_cli_run(dev, "sp", ["--mesh_seq", str(TP_RANKS), "--dist_backend", "gloo"])
    log(f"[train-parallel rank {rank}] (c) done: {r['steps']}")
    gc.collect()
    torch.cuda.empty_cache()

    # (d) finetune at --mesh_pipe 2: one decoder layer a stage
    pp_mesh = build_mesh(MeshConfig(data=1, fsdp=-1, tensor=1, pipe=TP_RANKS), device_type=device_type,
                         backend="gloo")
    cfg, vidlm, strategy, batch, r, _ = run("pp", "finetune", TP_FINETUNE_LAYERS, "fsdp-full-shard", pp_mesh, 8, 2,
                                            pipeline_parallel=True)
    tp_counts_reset()
    t = time.perf_counter()
    r["steps"] = tp_steps(strategy, batch, 2, {})
    r.update(tp_counts(), wall_s=time.perf_counter() - t, bytes=tp_bytes(vidlm, strategy.tx),
             held_layers=[i for i, layer in enumerate(vidlm.llm_backbone.decoder.layers)
                          if type(layer).__name__ != "ForeignLayer"],
             peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    res["pp"] = r
    log(f"[train-parallel rank {rank}] (d) done: {r['steps']}")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f, default=str)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


TP_SEED = 7  # cli/pretrain.py's default seed
TP_SAVED_MARK = "fsdp_saved"  # rank 0 writes it in the output directory once (b)'s step-1 checkpoint is whole


def tp_cli_run(dev, label: str, extra: list) -> dict:
    """``cli/pretrain.py``'s ``pretrain()`` on this rank with TP_CLI_ARGS +
    ``extra``, Llama-2-7B cut to TP_ALIGN_LAYERS. Inside its ``run_training``,
    before the loop: the trainables' digest and, on the rows of ``tp_batch``
    at this rank's batch coordinate, one micro-batch's gradients (rank 0
    saves them beside the runs); then the loop with the counters set to 0
    just before and read just after, its first ring K2 and last K3 call
    kept, held after the counts are read."""
    import dataclasses

    import torch

    import merv_tpu_torch.models.backbones.llm.base_llm as base_llm
    import merv_tpu_torch.training.strategies.base_strategy as BS
    from merv_tpu_torch.cli.pretrain import pretrain
    from merv_tpu_torch.conf import MERV_Base
    from merv_tpu_torch.parallel.mesh import batch_rank, batch_size, world

    r = dict(label=label, layers=TP_ALIGN_LAYERS,
             argv=TP_CLI_ARGS + ["--run_id", label, "--seed", str(TP_SEED)] + extra)
    run_training, rec = BS.TrainingStrategy.run_training, RingRecorder()

    def traced_run_training(self, dataset, collator, metrics, **kw):
        vidlm = self.vidlm
        transforms = [vb.get_video_transform() for vb in vidlm.video_backbones]
        r.update(world_size=self.world_size, accum=self.grad_accumulation_steps, per_device=self.per_device_batch_size,
                 start_hash=tp_hash(vidlm, [n for n, t_ in vidlm.trainable_mask().items() if t_]))
        rows = tp_rows(tp_batch(dev, vidlm, transforms, TP_SEED), self.grad_accumulation_steps, batch_rank(self.mesh),
                       batch_size(self.mesh))
        grads = tp_grads(self, rows, self.per_device_batch_size, transforms)
        if world()[0] == 0:  # beside the runs, not in chiprun_out/ (kept small: it is copied back from the card)
            torch.save(grads, os.path.join(TP_ROOT, f"{label}_grads.pt"))
        del grads, rows
        timings = []
        tp_counts_reset()
        t = time.perf_counter()
        with rec.active():
            run_training(self, dataset, collator, metrics, step_timings=timings, **kw)
        r.update(tp_counts(), wall_s=time.perf_counter() - t,
                 counted_micro_steps=self.grad_accumulation_steps * len(timings),
                 steps=[dict(loss=x["loss"], grad_norm=x["grad_norm"]) for x in timings],
                 peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        r["ring_holds"] = rec.holds()  # past the counted window

    llm_id = MERV_Base().llm_backbone_id
    spec = base_llm.LLM_SPECS[llm_id]
    spec = dataclasses.replace(spec, decoder_config=dataclasses.replace(spec.decoder_config,
                                                                        num_layers=TP_ALIGN_LAYERS))
    t = time.perf_counter()
    with patched((base_llm, "LLM_SPECS", dict(base_llm.LLM_SPECS, **{llm_id: spec})),
                 (BS.TrainingStrategy, "run_training", traced_run_training), *dataset_video_patches(TP_SEED)[2]):
        strategy = pretrain(args=r["argv"])
    r["process_s"] = time.perf_counter() - t
    del strategy
    return r


def tp_start(seed: int):
    """Write (c)'s dataset under TP_ROOT, then start the two ranks
    (``torch.distributed.run --nproc_per_node 2 chip_smoke.py
    --train-parallel-worker``) and the memory proof (on the host, the card
    hidden from it); their output under ``chiprun_out/train_parallel/``."""
    import socket

    out_dir = os.path.join("chiprun_out", "train_parallel")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(TP_ROOT, ignore_errors=True)
    os.makedirs(out_dir)
    os.makedirs(TP_ROOT)
    write_pretrain_dataset(TP_ROOT, seed, n_align=2 * TP_GLOBAL_BATCH, n_finetune=0)  # (c)'s: two steps' examples
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(TP_RANKS), "--master_addr",
           "localhost", "--master_port", str(port), os.path.abspath(__file__), "--train-parallel-worker", out_dir]
    logf = open(os.path.join(out_dir, "ranks.log"), "w")
    ranks = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT, text=True,
                             env=dict(os.environ, PYTHONFAULTHANDLER="1"))  # a crash's Python stack to the log
    proof_cmd = [sys.executable, "-m", "merv_tpu_torch.cli.memory_proof", "--stage", "finetune", "--model", "merv-full",
                 "--devices", "8", "--json-out", os.path.abspath(os.path.join(out_dir, "memory_proof.json"))]
    prooff = open(os.path.join(out_dir, "memory_proof.log"), "w")
    proof = subprocess.Popen(proof_cmd, stdout=prooff, stderr=subprocess.STDOUT, text=True,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    return dict(ranks=ranks, ranks_log=logf, proof=proof, proof_log=prooff, out_dir=out_dir, start=time.perf_counter())


def tp_state(tx) -> dict:
    """A one-device optimizer's state on the host, as its checkpoint holds it:
    the trainables by name, the AdamW moments by index, the step count."""
    sd = tx.state_dict()
    return dict(params={n: p.detach().float().cpu() for n, p in tx.named_params.items()}, count=sd["count"],
                moments={int(i): {k: v.detach().cpu().clone() for k, v in st.items()}
                         for i, st in sd["adamw"]["state"].items()})


def tp_world1(dev) -> dict:
    """The references at world 1 in this process: the finetune's two steps
    (step 1's loss and norm, the state after step 1, the kept bytes, the start
    digest) and the align model's digest and gradients on the first
    micro-batch."""
    import gc

    import torch

    out = {}
    cfg, vidlm, transforms = tp_model(dev, TP_SEED, "finetune", TP_FINETUNE_LAYERS)
    strategy = tp_strategy("fsdp-full-shard", vidlm, cfg, "finetune", 8, None, transforms,
                           os.path.join(TP_ROOT, "world1"))
    batch = tp_batch(dev, vidlm, transforms, TP_SEED)
    out["start_hash"] = tp_hash(vidlm, [n for n in strategy.tx.named_params])
    steps = tp_steps(strategy, batch, 1, {})
    out["step1_state"] = tp_state(strategy.tx)
    steps += tp_steps(strategy, batch, 1, {})
    out["finetune"] = dict(steps=steps, bytes=tp_bytes(vidlm, strategy.tx))
    del vidlm, strategy
    gc.collect()
    torch.cuda.empty_cache()
    cfg, vidlm, transforms = tp_model(dev, TP_SEED, "align", TP_ALIGN_LAYERS)
    strategy = tp_strategy("fsdp-shard-grad-op", vidlm, cfg, "align", 4, None, transforms,
                           os.path.join(TP_ROOT, "world1_align"))
    out["align_start_hash"] = tp_hash(vidlm, [n for n in strategy.tx.named_params])
    out["align_grads"] = tp_grads(strategy, tp_batch(dev, vidlm, transforms, TP_SEED), 4, transforms)
    del vidlm, strategy
    gc.collect()
    torch.cuda.empty_cache()
    return out


def state_rel(got: list, want: list) -> float:
    """Relative L2 of ``got`` against ``want`` over all the tensors together."""
    num = sum(float((a.float() - b.float()).square().sum()) for a, b in zip(got, want))
    return math.sqrt(num / sum(float(b.float().square().sum()) for b in want))


def halves_swapped(t):
    """``t`` as a gather that puts two ranks' dim-0 shards in the other order would give it."""
    import torch

    n = -(-t.shape[0] // 2) if t.dim() else 0
    return torch.cat([t[n:], t[:n]]) if t.dim() and t.shape[0] > 1 else t


def tp_file_checks(saved: dict, want: dict) -> dict:
    """(b)'s checkpoint file against world 1's state after step 1 (``tp_state``):
    the trainables and each AdamW moment, relative L2 over all tensors of a
    kind, the step counts; and the same readings for two planted faults of
    a sharded save: each tensor's dim-0 halves swapped (a gather in the other
    rank order), and each moment taken from the next index of its shape (the
    moments misnumbered)."""
    params = {f"{key}.{rest}": t for key, sd in saved["model"].items() for rest, t in sd.items()}
    names = sorted(want["params"])
    if sorted(params) != names:
        return dict(ok=False, names=dict(file_only=sorted(set(params) - set(names)),
                                          world1_only=sorted(set(names) - set(params))))
    opt = saved["optimizer"]
    moments = {int(i): st for i, st in opt["adamw"]["state"].items()}
    out = dict(count=opt["count"], steps=sorted({int(st["step"]) for st in moments.values()}),
               indices_equal=sorted(moments) == sorted(want["moments"]),
               shapes_equal=all(moments[i][k].shape == want["moments"][i][k].shape for i in want["moments"]
                                if i in moments for k in ("exp_avg", "exp_avg_sq")))
    out["params_rel"] = state_rel([params[n] for n in names], [want["params"][n] for n in names])
    out["planted_halves_swapped"] = state_rel([halves_swapped(params[n]) for n in names],
                                              [want["params"][n] for n in names])
    if out["indices_equal"] and out["shapes_equal"]:
        idx = sorted(want["moments"])
        by_shape = {}
        for i in idx:
            by_shape.setdefault(tuple(want["moments"][i]["exp_avg"].shape), []).append(i)
        nxt = {i: g[(g.index(i) + 1) % len(g)] for g in by_shape.values() for i in g}
        for k in ("exp_avg", "exp_avg_sq"):
            want_k = [want["moments"][i][k] for i in idx]
            out[f"{k}_rel"] = state_rel([moments[i][k] for i in idx], want_k)
            out[f"planted_{k}_misnumbered"] = state_rel([moments[nxt[i]][k] for i in idx], want_k)
            out[f"planted_{k}_halves_swapped"] = state_rel([halves_swapped(moments[i][k]) for i in idx], want_k)
    out["ok"] = bool(
        out["count"] == want["count"] == 1 and out["steps"] == [1] and out["indices_equal"] and out["shapes_equal"]
        and out["params_rel"] <= TP_PARAM_REL_TOL < out["planted_halves_swapped"]
        and all(out[f"{k}_rel"] <= TP_GRAD_REL_TOL < min(out[f"planted_{k}_misnumbered"],
                                                         out[f"planted_{k}_halves_swapped"])
                for k in ("exp_avg", "exp_avg_sq")))
    return out


def tp_resume_check(dev, want: dict) -> dict:
    """(b)'s step-1 checkpoint, written by the two ranks: held against world
    1's state after its step 1 (``tp_file_checks``), and loaded by a world-1
    strategy: every trainable equal to the file's tensor in every bit."""
    import gc

    import torch

    from merv_tpu_torch.training import get_train_strategy
    from merv_tpu_torch.training.checkpointing import latest_checkpoint, load_checkpoint

    ckpt = latest_checkpoint(os.path.join(TP_ROOT, "fsdp"))
    saved = load_checkpoint(ckpt)
    file_checks = tp_file_checks(saved, want)
    cfg, vidlm, transforms = tp_model(dev, TP_SEED, "finetune", TP_FINETUNE_LAYERS)
    strategy = get_train_strategy("fsdp-full-shard", vidlm, stage="finetune", max_steps=2,
                                  global_batch_size=TP_GLOBAL_BATCH, per_device_batch_size=8,
                                  learning_rate=cfg.finetune_learning_rate, weight_decay=cfg.finetune_weight_decay,
                                  max_grad_norm=cfg.finetune_max_grad_norm, lr_scheduler_type="constant")
    strategy.run_setup(os.path.join(TP_ROOT, "resumed"), n_train_examples=TP_GLOBAL_BATCH,
                       video_transforms=transforms, resume_from_checkpoint=ckpt)
    params = dict(vidlm.named_parameters())
    differ = [f"{key}.{rest}" for key, sd in saved["model"].items() for rest, t in sd.items()
              if not torch.equal(params[f"{key}.{rest}"].detach().cpu(), t)]
    moments = sum(1 for st in strategy.tx.adamw.state.values() for v in st.values() if v.dim())
    out = dict(checkpoint=os.path.basename(ckpt), tensors=sum(len(sd) for sd in saved["model"].values()),
               differ=differ, resume_step=strategy._resume_step, count=strategy.tx.count, moments=moments,
               file_gib=os.path.getsize(os.path.join(ckpt, "checkpoint.pt")) / 2**30, against_world1=file_checks)
    del vidlm, strategy, saved, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_predicted(label: str, r: dict) -> dict:
    """A rank's launches as the configs give them: the towers' 46 K1 and 12 K2
    (ViViT) a micro-step; a decoder layer's K2 twice (the forward and its
    recompute under remat) and K3 once, on the layers the rank runs: all of
    them (fsdp), each layer's ring blocks on this rank (sp: the zigzag ring's
    n(n+2) blocks over n ranks, n + 2 a rank), its stage's layers once a
    pipeline micro-batch (pp)."""
    import merv_tpu_torch.ops.attention as A
    from merv_tpu_torch.ops.ring_attention import ring_block_count

    micro = r["counted_micro_steps"]
    if label == "sp":
        blocks = ring_block_count(TP_RANKS, True, True) // TP_RANKS
        per_layer = (2 * blocks, blocks)
        layers = TP_ALIGN_LAYERS
    elif label == "pp":
        from merv_tpu_torch.parallel.pipeline import resolve_microbatches

        m = resolve_microbatches(r["per_device"], TP_RANKS)
        per_layer, layers = (2 * m, m), TP_FINETUNE_LAYERS // TP_RANKS
    else:
        per_layer, layers = (2, 1), TP_FINETUNE_LAYERS
    per = {"small_attention_kt": 46, "flash_attention_forward": 12 + per_layer[0] * layers,
           "flash_attention_backward": per_layer[1] * layers, "layer_norm": TOWER_LN}
    return {k: per[k] * micro for k in per if per[k]} | {k: 0 for k in A.launch_counts() if k not in per}


def tp_step2(ranks: list, w1: dict) -> dict:
    """Step 2's loss and norm on every rank against world 1's step 2 (relative)."""
    rel = {k: max(abs(r["steps"][1][k] - w1["steps"][1][k]) / abs(w1["steps"][1][k]) for r in ranks)
           for k in ("loss", "grad_norm")}
    return dict(rel, ok=all(v <= TP_STEP2_REL_TOL for v in rel.values()))


def tp_cli_outputs(label: str) -> dict:
    """What (c)'s ``cli/pretrain.py`` run left in its run directory: the steps
    of its metrics file (rank 0 alone writes it), whether its step-1
    checkpoint (written async) and ``latest-checkpoint`` have their meta.json."""
    from merv_tpu_torch.training.checkpointing import latest_checkpoint

    run_dir = os.path.join(TP_ROOT, "runs", label)
    ckpts = os.path.join(run_dir, "checkpoints")
    step1 = [d for d in sorted(os.listdir(ckpts)) if d.startswith("step-000001-")]
    latest = latest_checkpoint(run_dir)
    return dict(logged_steps=[json.loads(x)["Align/Step"] for x in open(os.path.join(run_dir, f"{label}.jsonl"))],
                checkpoints=sorted(os.listdir(ckpts)),
                async_checkpoint=bool(step1) and os.path.exists(os.path.join(ckpts, step1[0], "meta.json")),
                latest_ok=latest is not None and os.path.exists(os.path.join(latest, "meta.json")))


def train_parallel_path(dev, seed: int) -> dict:
    """Phase 5c (see the module's text): the ranks and the memory proof
    start, this process runs the world-1 references meanwhile, then every
    check."""
    import torch

    t0 = time.perf_counter()
    started = tp_start(seed)
    log(f"[train-parallel] two ranks on the card over gloo and the memory proof (merv-full finetune at 7B, 8 fake "
        f"ranks, on the host) started; cut: Llama-2-7B at full width, {TP_FINETUNE_LAYERS} layers (finetune) / "
        f"{TP_ALIGN_LAYERS} (align), global batch {TP_GLOBAL_BATCH}: two ranks and this process's world-1 "
        f"reference share the one card (full finetune at 7B needs ~108 GB; the memory proof answers for 8 cards)")
    ref = tp_world1(dev)
    t_ref = time.perf_counter() - t0
    out_dir = started["out_dir"]
    mark, deadline = os.path.join(out_dir, TP_SAVED_MARK), started["start"] + 900
    while not os.path.exists(mark) and started["ranks"].poll() is None and time.perf_counter() < deadline:
        time.sleep(1)
    resume = tp_resume_check(dev, ref.pop("step1_state")) if os.path.exists(mark) else None
    t_resume = time.perf_counter() - t0
    rc = started["ranks"].wait(timeout=max(1.0, deadline - time.perf_counter()))
    started["ranks_log"].close()
    t_ranks = time.perf_counter() - started["start"]
    proof_rc = started["proof"].wait(timeout=600)
    started["proof_log"].close()
    t_proof = time.perf_counter() - started["start"]
    if rc != 0 or resume is None:
        tail = open(os.path.join(out_dir, "ranks.log")).read()[-3000:]
        raise RuntimeError(f"the train-parallel ranks exited {rc} (step-1 checkpoint written: {resume is not None}):"
                           f"\n{tail}")
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(TP_RANKS)]
    proof = json.load(open(os.path.join(out_dir, "memory_proof.json"))) if os.path.exists(
        os.path.join(out_dir, "memory_proof.json")) else None
    failures = []

    # (a) the probe
    probe = ranks[0]["gloo_probe"]
    log(f"[train-parallel] (a) gloo on CUDA tensors: {probe}")

    # (b) fsdp-full-shard finetune against world 1
    w1 = ref["finetune"]
    b = [r["fsdp"] for r in ranks]
    rel = lambda a, c: abs(a - c) / abs(c)  # noqa: E731
    loss_rel = max(rel(r["steps"][0]["loss"], w1["steps"][0]["loss"]) for r in b)
    norm_rel = max(rel(r["steps"][0]["grad_norm"], w1["steps"][0]["grad_norm"]) for r in b)
    # planted faults on the same step: each data rank's own token mean averaged (trap a), one rank's shards' norm (d)
    planted_loss = rel(tp_rank_mean_loss(b, 0, b[0]["accum"]), w1["steps"][0]["loss"])
    planted_norm = max(rel(r["record"]["local_norms"][0], w1["steps"][0]["grad_norm"]) for r in b)
    share = [r["bytes"]["params_and_optimizer"] / w1["bytes"]["params_and_optimizer"] for r in b]
    hashes = [r["start_hash"] for r in b] + [ref["start_hash"]]
    for r in b:
        want = tp_predicted("fsdp", r)
        if r["launches"] != {k: v for k, v in want.items() if v}:
            failures.append(f"(b) rank launches {r['launches']}, predicted {want}")
    if len(set(hashes)) != 1:
        failures.append(f"(b) the ranks did not start from world 1's trainables: {hashes}")
    if not (loss_rel <= TP_LOSS_REL_TOL < planted_loss and norm_rel <= TP_NORM_REL_TOL < planted_norm):
        failures.append(f"(b) step 1 against world 1: loss {loss_rel:.3e} (limit {TP_LOSS_REL_TOL}, planted "
                        f"{planted_loss:.3e}), norm {norm_rel:.3e} (limit {TP_NORM_REL_TOL}, planted {planted_norm:.3e})")
    if not all(0.48 <= s <= 0.52 for s in share):
        failures.append(f"(b) a rank's params + AdamW bytes {share} of world 1's, not 0.48-0.52")
    if resume["differ"] or resume["resume_step"] != 1 or resume["count"] != 1 or not resume["against_world1"]["ok"]:
        failures.append(f"(b) the step-1 checkpoint against world 1's state (trainables limit {TP_PARAM_REL_TOL}, "
                        f"moments {TP_GRAD_REL_TOL}) and resumed at world 1: {resume}")
    step2 = tp_step2(b, w1)
    if not step2["ok"]:
        failures.append(f"(b) step 2 against world 1's: {step2} (limit {TP_STEP2_REL_TOL})")
    log(f"[train-parallel] (b) fsdp-full-shard, 2 ranks: step-1 loss {[r['steps'][0]['loss'] for r in b]} against "
        f"world 1's {w1['steps'][0]['loss']:.6f} (relative {loss_rel:.3e}, limit {TP_LOSS_REL_TOL}; each rank's own "
        f"token mean averaged: {planted_loss:.3e}); grad norm {[r['steps'][0]['grad_norm'] for r in b]} against "
        f"{w1['steps'][0]['grad_norm']:.6f} ({norm_rel:.3e}, limit {TP_NORM_REL_TOL}; one rank's shards alone: "
        f"{planted_norm:.3e}); step 2 against world 1's {step2} (limit {TP_STEP2_REL_TOL}); "
        f"params + AdamW bytes a rank {share} of world 1's; start digests {hashes}; launches "
        f"{[r['launches'] for r in b]}; collectives none counted (FSDP2's own); steps {b[0]['wall_s']:.1f} s; "
        f"peak {[round(r['peak_memory_gib'], 2) for r in b]} GiB; resume at world 1: {resume}")

    # (c) align at sp = 2 through cli/pretrain.py
    c = [r["sp"] for r in ranks]
    sp_grads = torch.load(os.path.join(TP_ROOT, "sp_grads.pt"))
    rels = {}
    for key in ("projectors", "feature_fusion"):
        a = torch.cat([sp_grads[n].flatten() for n in sp_grads if n.startswith(key + ".")])
        w = torch.cat([ref["align_grads"][n].flatten() for n in ref["align_grads"] if n.startswith(key + ".")])
        rels[key] = dict(rel_l2=rel_l2(a, w), planted_sum=rel_l2(2 * a, w))
    for r in c:
        want = tp_predicted("sp", r)
        if r["launches"] != {k: v for k, v in want.items() if v}:
            failures.append(f"(c) rank launches {r['launches']}, predicted {want}")
        if not all(h["ok"] for h in r["ring_holds"].values()) or len(r["ring_holds"]) != 2:
            failures.append(f"(c) a rank's first ring K2 / K3 call against the plain versions: {r['ring_holds']}")
    if not all(v["rel_l2"] <= TP_GRAD_REL_TOL < v["planted_sum"] for v in rels.values()):
        failures.append(f"(c) one micro-batch's gradients against world 1's: {rels} (limit {TP_GRAD_REL_TOL})")
    cli = tp_cli_outputs("sp")
    sp_hashes = [r["start_hash"] for r in c] + [ref["align_start_hash"]]
    losses = [[st["loss"] for st in r["steps"]] for r in c]
    if len(set(sp_hashes)) != 1:
        failures.append(f"(c) the CLI's ranks did not start from world 1's align trainables: {sp_hashes}")
    if len(losses[0]) != 2 or not all(math.isfinite(x) for x in losses[0]) or \
            max(abs(x - y) / abs(y) for x, y in zip(losses[1], losses[0])) > TP_LOSS_REL_TOL:
        failures.append(f"(c) the ranks' losses {losses}: two finite steps, the same on every sp rank")
    if cli["logged_steps"] != [1, 2] or not cli["async_checkpoint"] or not cli["latest_ok"]:
        failures.append(f"(c) the CLI's outputs (rank 0 logs steps 1 and 2 once, its async step-1 checkpoint and "
                        f"the latest with meta.json): {cli}")
    log(f"[train-parallel] (c) align at --mesh_seq 2 through cli/pretrain.py ({c[0]['process_s']:.1f} s a rank; "
        f"{' '.join(c[0]['argv'])}): gradients on one micro-batch against world 1's {rels} (limit "
        f"{TP_GRAD_REL_TOL}); launches {[r['launches'] for r in c]} (predicted {tp_predicted('sp', c[0])}); "
        f"collectives {[r['collectives'] for r in c]}; first ring K2 / K3 calls held {[r['ring_holds'] for r in c]}; "
        f"loop {c[0]['wall_s']:.1f} s, losses {losses}; start digests {sp_hashes}; outputs {cli}")

    # (d) finetune at pp = 2
    d = [r["pp"] for r in ranks]
    pp_loss = max(rel(r["steps"][0]["loss"], w1["steps"][0]["loss"]) for r in d)
    pp_norm = max(rel(r["steps"][0]["grad_norm"], w1["steps"][0]["grad_norm"]) for r in d)
    layer_share = [r["bytes"]["llm_layers"] / w1["bytes"]["llm_layers"] for r in d]
    for r in d:
        want = tp_predicted("pp", r)
        if r["launches"] != {k: v for k, v in want.items() if v}:
            failures.append(f"(d) rank launches {r['launches']}, predicted {want}")
    if [r["held_layers"] for r in d] != [[i] for i in range(TP_RANKS)] or layer_share != [0.5] * TP_RANKS:
        failures.append(f"(d) layers held {[r['held_layers'] for r in d]}, layer bytes {layer_share} of world 1's")
    if not pp_loss <= TP_LOSS_REL_TOL or not pp_norm <= TP_NORM_REL_TOL:
        failures.append(f"(d) step 1 against world 1: loss {pp_loss:.3e}, norm {pp_norm:.3e}")
    pp_step2 = tp_step2(d, w1)
    if not pp_step2["ok"]:
        failures.append(f"(d) step 2 against world 1's: {pp_step2} (limit {TP_STEP2_REL_TOL})")
    log(f"[train-parallel] (d) finetune at --mesh_pipe 2: step-1 loss {[r['steps'][0]['loss'] for r in d]} "
        f"(relative {pp_loss:.3e}), norm {[r['steps'][0]['grad_norm'] for r in d]} ({pp_norm:.3e}); step 2 "
        f"{pp_step2}; layers held "
        f"{[r['held_layers'] for r in d]}, layer bytes {layer_share} of world 1's; launches "
        f"{[r['launches'] for r in d]} (predicted {tp_predicted('pp', d[0])}); collectives "
        f"{[r['collectives'] for r in d]}; steps {d[0]['wall_s']:.1f} s")

    # (e) the memory proof
    if proof_rc not in (0, 1) or proof is None:
        failures.append(f"(e) the memory proof exited {proof_rc}")
    else:
        ft = proof["stages"]["finetune"]["ranks"][0]
        log(f"[train-parallel] (e) memory proof, merv-full finetune at 7B, fsdp-full-shard over 8 ranks (fake): "
            f"peak {ft['peak_gib']:.2f} GiB a rank {ft['peak_split_gib']}; kept {ft['kept_gib']}; fits the "
            f"{proof['card']}'s {proof['budget_gib']:.2f} GiB: {proof['fits']} (traced in {ft['trace_s']:.1f} s)")
    wall = time.perf_counter() - t0
    log(f"[train-parallel] phase 5c: {wall:.1f} s (world-1 references {t_ref:.1f} s, then the resume check, ended at "
        f"{t_resume:.1f} s; ranks {t_ranks:.1f} s; the memory proof's process {t_proof:.1f} s)")
    shutil.rmtree(TP_ROOT, ignore_errors=True)
    if failures:
        raise RuntimeError("phase 5c: " + "; ".join(failures))
    return dict(gloo_probe=probe, ranks=ranks, world1={k: v for k, v in ref.items() if k != "align_grads"},
                resume=resume, sp_grad_rel=rels, sp_cli=cli, step2=dict(fsdp=step2, pp=pp_step2),
                memory_proof=proof, loss_rel=loss_rel, norm_rel=norm_rel,
                planted=dict(rank_mean_loss=planted_loss, one_rank_norm=planted_norm), pp_loss_rel=pp_loss,
                pp_norm_rel=pp_norm, bytes_share=share, pp_layer_share=layer_share, wall_s=wall,
                launches={f"{label}_rank{i}": ranks[i][label]["launches"] for label in ("fsdp", "sp", "pp")
                          for i in range(TP_RANKS)})


# ---------------------------------------------------------------------------
# phase 6: the bench and tooling modules
# ---------------------------------------------------------------------------

BENCH_ROOT = os.path.join("runs", "chip_smoke_bench")  # export_towers' and preprocess' inputs and outputs
BENCH_LLM_LAYERS = 2  # the benches' LLM depth here (their defaults are 8 to 32): width is what they hold
BENCH_PARALLEL = 5  # bench processes at once: a smoke check of each, not their measurement (PERF.md's readings
# come from runs at the benches' defaults, one at a time)
# tower_attn's five routes (one child process each) in two processes that run at once: the kernels' routes (K1, B3,
# B6) and the two that add none (`xla_kt`) or run K1 through the model (`default`)
TOWER_IMPLS = ("small", "xla", "fused_block")
TOWER_IMPLS_MORE = ("xla_kt", "default")
BENCH_FIRST = ("tower_attn", "serving", "tower_attn_more", "vidlm_prefix_engine_shared", "loader")  # the longest first
TOWER_IMPL_KERNEL = {"small": "small_attention_kt", "xla_kt": None, "xla": "small_attention",
                     "fused_block": "fused_vit_attn_block", "default": "small_attention_kt"}
# K1 a call of the merv set's DINOv2 or LanguageBind tower (23 layers each: the penultimate-layer tap), K2 of ViViT
TOWER_LAYER_CALLS = 23
VIVIT_LAYERS = 12
BENCH_ENV = {"BENCH_LLM_LAYERS": str(BENCH_LLM_LAYERS), "BENCH_TOWERS": "merv"}
# label -> (the module's arguments, its environment on top of BENCH_ENV)
BENCH_RUNS = {
    "decode_bf16": (["merv_tpu_torch.bench.decode"], {"BENCH_DECODE_STEPS": "8"}),
    "decode_int8": (["merv_tpu_torch.bench.decode"], {"BENCH_DECODE_STEPS": "8", "BENCH_INT8": "1",
                                                      "BENCH_INT8_KV": "1"}),
    "train": (["merv_tpu_torch.bench.train"], {}),
    "serving": (["merv_tpu_torch.bench.serving"], {"BENCH_REQUESTS": "4"}),
    "breakdown": (["merv_tpu_torch.bench.breakdown", "--layers", str(BENCH_LLM_LAYERS), "--batch", "1"], {}),
    "tower_attn": (["merv_tpu_torch.bench.tower_attn", "--batch", "1", "--impls", ",".join(TOWER_IMPLS)], {}),
    "tower_attn_more": (["merv_tpu_torch.bench.tower_attn", "--batch", "1", "--impls", ",".join(TOWER_IMPLS_MORE)], {}),
    "tower_ops": (["merv_tpu_torch.bench.tower_ops", "--tower", "dinov2", "--batch", "1"], {}),
    "loader": (["merv_tpu_torch.bench.loader", "--seconds", "2"], {}),
}
# the merv_tpu script's keys each result line must hold (scripts/bench_*.py, at the lines cited)
BENCH_KEYS = {
    "decode": {"metric", "decode_tokens_per_sec", "ttft_p50_sec", "unit"},  # bench_decode.py:109-117
    "train": {"metric", "examples_per_sec", "step_sec", "loss"},  # bench_train.py:105-110
    "serving": {"metric", "layers", "slots", "requests", "total_new_tokens", "group_tok_s", "engine_tok_s",
                "engine_vs_group", "engine_util", "spec_tok_s", "spec_tokens_per_step", "spec_step_overhead", "int8",
                "int8_kv", "platform"},  # bench_serving.py:470-488
    "breakdown": {"towers_ms", "projectors_fusion_ms", "llm_prefill_ms", "sum_ms"},  # bench_breakdown.py:85-106
    "tower_attn": {"batch", "rows"},  # bench_tower_attn.py:128
    "tower_ops": {"tower", "batch", "components_ms"},  # bench_tower_ops.py:179-180
    "loader": {"metric", "value", "unit", "workers_to_saturate_device"},  # bench_loader.py:96-101
    "vidlm_prefix": {"serving_wall_s", "questions_per_sec", "proc_s"},  # bench_vidlm_prefix.py:86-101
}
# every rate and time in a line, by the bench's own keys
BENCH_POSITIVE = {
    "decode": ("decode_tokens_per_sec", "ttft_p50_sec"), "train": ("examples_per_sec", "step_sec"),
    "serving": ("group_tok_s", "engine_tok_s", "engine_vs_group", "spec_tok_s", "spec_tokens_per_step",
                "spec_step_overhead"),
    "breakdown": ("projectors_fusion_ms", "llm_prefill_ms", "sum_ms"), "loader": ("value", "prefill_videos_per_sec"),
    "vidlm_prefix": ("serving_wall_s", "questions_per_sec"),
}


def llm_launches(prefill_lengths, decode_forwards: int, layers: int) -> dict:
    """K2 / K5 launches of LLM work with a cache: a prefill program of T
    tokens runs K5 a layer when T <= 16, else K2; every decode or verify
    forward runs K5 a layer."""
    return {"flash_attention_forward": layers * sum(t > 16 for t in prefill_lengths),
            "decode_attention": layers * (decode_forwards + sum(t <= 16 for t in prefill_lengths))}


def bench_expected(kind: str, out: dict, layers: int = BENCH_LLM_LAYERS) -> dict:
    """The launches a bench's run must show, worked out from its shapes and
    the work its result line reports; the kernels not named, none."""
    L, K1, K2, LN = layers, 2 * TOWER_LAYER_CALLS, VIVIT_LAYERS, TOWER_LN
    if kind == "decode":
        n, fwd = out["prefills"], out["decode_steps"] + out["captured_steps"]
        want = {"small_attention_kt": K1 * n, "flash_attention_forward": (K2 + L) * n, "decode_attention": L * fwd,
                "layer_norm": LN * n}
        if out["int8"]:  # 4 packed Linears a layer and the lm_head a step; the prefill's lm_head on its 1 row
            want["int8_linear"] = (4 * L + 1) * fwd + n
        return want
    if kind == "train":  # the LLM's attention forward twice a step under remat, its backward once
        n = out["steps"]
        return {"small_attention_kt": K1 * n, "flash_attention_forward": (K2 + 2 * L) * n,
                "flash_attention_backward": L * n, "layer_norm": LN * n}
    if kind == "serving_phase":
        return llm_launches(out["work"]["prefill_lengths"], out["work"]["decode_forwards"], L)
    if kind == "breakdown":  # each tower's timed calls and encode_videos' one; the LLM prefill's calls
        per_tower = out["calls"]["towers"] // len(out["towers_ms"]) + 1
        return {"small_attention_kt": K1 * per_tower,
                "flash_attention_forward": K2 * per_tower + L * out["calls"]["llm_prefill"], "layer_norm": LN * per_tower}
    if kind == "tower_attn_row":  # LanguageBind and DINOv2 called alike
        name = TOWER_IMPL_KERNEL[out["impl"]]
        norms = sum(TOWER_NORMS[t][out["impl"] == "fused_block"]
                    for t in ("languagebind-video-noclass", "dinov2-video-all-tokens"))
        return {**({name: TOWER_LAYER_CALLS * out["calls"]} if name else {}), "layer_norm": norms * out["calls"] // 2}
    if kind == "tower_ops":  # the tower's 23 layers a forward; the attention chain's one a layer of the config
        calls = out["calls"]
        chain = next(n for n in calls if n.startswith("attention chain"))
        tower = calls["full tower"] + calls["full tower, fp32 input"]
        return {"small_attention_kt": TOWER_LAYER_CALLS * tower + out["layers"] * calls[chain],
                "layer_norm": TOWER_NORMS["dinov2-video-all-tokens"][0] * tower}
    if kind == "loader":
        n = out["prefills"]
        return {"small_attention_kt": K1 * n, "flash_attention_forward": (K2 + L) * n, "layer_norm": LN * n}
    raise ValueError(kind)


def check_launches(label: str, launches: dict, want: dict) -> dict:
    import merv_tpu_torch.ops.attention as A

    full = {name: want.get(name, 0) for name in A.launch_counts()}
    if launches != full:
        raise RuntimeError(f"[bench] {label}: launches {launches}, its shapes give {full}")
    return full


def check_line(label: str, kind: str, out: dict, kind_name: str) -> None:
    """The merv_tpu script's keys, every rate and time finite and > 0, the card named."""
    missing = BENCH_KEYS[kind] - set(out)
    if missing:
        raise RuntimeError(f"[bench] {label}: result line lacks {sorted(missing)} of the merv_tpu script's keys")
    values = [out[k] for k in BENCH_POSITIVE.get(kind, ())]
    if kind == "breakdown":
        values += list(out["towers_ms"].values())
    if kind == "tower_attn":
        values += [r[k] for r in out["rows"] for k in ("languagebind_ms", "dinov2_ms")]
    if kind == "tower_ops":
        values += list(out["components_ms"].values())
    bad = [v for v in values if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0)]
    if bad:
        raise RuntimeError(f"[bench] {label}: a rate or time is not finite and > 0: {bad} in {out}")
    if kind != "vidlm_prefix" and out.get("device") != kind_name:
        raise RuntimeError(f"[bench] {label}: ran on {out.get('device')!r}, not on the card {kind_name!r}")


def languagebind_checkpoint(cfg, seed: int) -> dict:
    """A LanguageBind_Video_merge-shaped checkpoint at ``cfg``'s widths from a
    seeded generator: the ``vision_model.*`` tensors under the HF CLIP names,
    with a text tower's tensor and ``logit_scale`` beside them, as the released
    dual-tower file has them."""
    import torch

    g = torch.Generator().manual_seed(seed)
    D, inner, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    n_pos = (cfg.image_size // p) ** 2 + 1
    shapes = {"embeddings.class_embedding": (D,), "embeddings.patch_embedding.weight": (D, 3, p, p),
              "embeddings.position_embedding.weight": (n_pos, D)}
    for n in ("pre_layrnorm", "post_layernorm"):
        shapes.update({f"{n}.weight": (D,), f"{n}.bias": (D,)})
    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}"
        for n in ("layer_norm1", "layer_norm2", "temporal_layer_norm1"):
            shapes.update({f"{pre}.{n}.weight": (D,), f"{pre}.{n}.bias": (D,)})
        for a in ("self_attn", "temporal_attn"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                shapes.update({f"{pre}.{a}.{proj}.weight": (D, D), f"{pre}.{a}.{proj}.bias": (D,)})
        shapes.update({f"{pre}.mlp.fc1.weight": (inner, D), f"{pre}.mlp.fc1.bias": (inner,),
                       f"{pre}.mlp.fc2.weight": (D, inner), f"{pre}.mlp.fc2.bias": (D,),
                       f"{pre}.temporal_embedding": (1, cfg.temporal_frames, D)})
    state = {f"vision_model.{k}": torch.randn(s, generator=g) * 0.02 for k, s in shapes.items()}
    state["vision_model.embeddings.position_ids"] = torch.arange(n_pos)[None]
    state.update({"text_model.embeddings.token_embedding.weight": torch.zeros(7, 4), "logit_scale": torch.ones(())})
    return state


def hiera_checkpoint(cfg, seed: int) -> dict:
    """An original-repository Hiera state dict at ``cfg``'s widths from a
    seeded generator, with its classifier head, nested under ``model_state``
    as the released ``.pth`` files are."""
    import torch

    g = torch.Generator().manual_seed(seed)
    t, h, w = cfg.tokens_shape
    shapes = {"patch_embed.proj.weight": (cfg.embed_dim, 3, *cfg.patch_kernel), "patch_embed.proj.bias": (cfg.embed_dim,),
              "pos_embed_spatial": (1, h * w, cfg.embed_dim), "pos_embed_temporal": (1, t, cfg.embed_dim),
              "head.projection.weight": (400, cfg.final_dim), "head.projection.bias": (400,)}
    for i, lp in enumerate(cfg.layer_plan()):
        d_in, d_out = lp["dim_in"], lp["dim_out"]
        hidden = int(d_out * cfg.mlp_ratio)
        parts = {"norm1": (d_in,), "attn.qkv": (3 * d_out, d_in), "attn.proj": (d_out, d_out), "norm2": (d_out,),
                 "mlp.fc1": (hidden, d_out), "mlp.fc2": (d_out, hidden)}
        if d_in != d_out:
            parts["proj"] = (d_out, d_in)
        for n, shape in parts.items():
            shapes[f"blocks.{i}.{n}.weight"] = shape
            shapes[f"blocks.{i}.{n}.bias"] = (shape[0],)
    return {"model_state": {k: torch.randn(s, generator=g) * 0.02 for k, s in shapes.items()}}


EXPORTED_TOWERS = ("languagebind-video-noclass", "hiera-base-plus-video")


def export_inputs(root: str, seed: int) -> tuple:
    """The two local checkpoints ``cli/export_towers.py`` reads, at the towers'
    full widths from the seed -> (its arguments, {tower id: the tensors its file must hold})."""
    import torch

    from merv_tpu_torch.benchkit import META
    from merv_tpu_torch.models.materialize import get_video_backbone_and_transform

    (lb, hiera), _ = get_video_backbone_and_transform(list(EXPORTED_TOWERS), "resize-naive", [16, 16], device=META)
    lb_state, hiera_state = languagebind_checkpoint(lb.vit_config, seed), hiera_checkpoint(hiera.hiera_config, seed + 1)
    os.makedirs(root, exist_ok=True)
    lb_path, hiera_path = os.path.join(root, "languagebind_video_merge.pt"), os.path.join(root, "hiera.pth")
    torch.save(lb_state, lb_path)
    torch.save(hiera_state, hiera_path)
    want = {EXPORTED_TOWERS[0]: {k: v for k, v in lb_state.items()
                                 if k.startswith("vision_model.") and not k.endswith("position_ids")},
            EXPORTED_TOWERS[1]: {k: v for k, v in hiera_state["model_state"].items() if not k.startswith("head.")}}
    args = ["merv_tpu_torch.cli.export_towers", "--out", os.path.join(root, "towers"), "--towers", *EXPORTED_TOWERS,
            "--source", f"languagebind={lb_path}", "--source", f"hiera={hiera_path}"]
    return args, want


def check_export(root: str, want: dict) -> dict:
    import torch

    from merv_tpu_torch.util.safetensors_io import load_file

    out = {}
    for ident, tensors in want.items():
        got = load_file(os.path.join(root, "towers", f"{ident}.safetensors"))
        if sorted(got) != sorted(tensors) or not all(got[k].dtype == torch.float32 and torch.equal(got[k], tensors[k])
                                                     for k in tensors):
            raise RuntimeError(f"[bench] export_towers: {ident}.safetensors does not hold its checkpoint's tensors")
        out[ident] = len(got)
    return out


PREPROCESS_IMAGES = 6


def preprocess_inputs(root: str, seed: int) -> list:
    """llava-v1.5-instruct laid out under ``root`` with every component in place
    (nothing to fetch) and OCR-VQA's images as seeded PNG and GIF files ->
    ``cli/preprocess.py``'s arguments."""
    import numpy as np
    from PIL import Image

    from merv_tpu_torch.preprocessing.download import DATASET_REGISTRY

    base = os.path.join(root, "download", "llava-v1.5-instruct")
    for comp in DATASET_REGISTRY["llava-v1.5-instruct"]:
        target = os.path.join(base, comp["name"])
        if comp.get("extract"):
            os.makedirs(target, exist_ok=True)
        else:
            os.makedirs(os.path.dirname(target), exist_ok=True)
            with open(target, "w") as f:
                f.write("[]")
    rng = np.random.default_rng(seed)
    for i in range(PREPROCESS_IMAGES):
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(
            os.path.join(base, "ocr_vqa", "images", f"{i}{('.png', '.gif')[i % 2]}"))
    return ["merv_tpu_torch.cli.preprocess", "--dataset_id", "llava-v1.5-instruct", "--root_dir", root]


def check_preprocess(root: str) -> int:
    from PIL import Image

    images = os.path.join(root, "download", "llava-v1.5-instruct", "ocr_vqa", "images")
    jpgs = sorted(f for f in os.listdir(images) if f.endswith(".jpg"))
    if len(jpgs) != PREPROCESS_IMAGES:
        raise RuntimeError(f"[bench] preprocess: {len(jpgs)} JPGs written for {PREPROCESS_IMAGES} images")
    for name in jpgs:
        if Image.open(os.path.join(images, name)).size != (64, 48):
            raise RuntimeError(f"[bench] preprocess: {name} is not its source's size")
    return len(jpgs)


def run_tool_process(args: list, env: dict) -> tuple:
    """``python -m <args>`` (a tool that prints no result line) -> (None, None,
    seconds, the end of its stderr); raises if it fails."""
    from merv_tpu_torch import benchkit

    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], env=benchkit.child_env(env), capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"[bench] {args[0]} failed (rc={proc.returncode}): {proc.stderr[-3000:]}")
    return None, None, time.perf_counter() - t, proc.stderr[-1500:]


def run_bench_process(args: list, env: dict) -> tuple:
    """``python -m <args>`` with the repository on its path -> (its result
    line, its launches line, seconds, the end of its stderr); raises if it
    fails or prints no result."""
    from merv_tpu_torch import benchkit

    t = time.perf_counter()
    out, launches, proc = benchkit.run_child(args, env=env, timeout=900)
    return out, launches, time.perf_counter() - t, proc.stderr[-1500:]


def bench_path(dev, seed: int) -> dict:
    """Phase 6: each bench module and tool once on the card at full width
    (depth and counts cut through the benches' own ``BENCH_*`` names), each in
    a process of its own, ``BENCH_PARALLEL`` at once. Checks each result line
    (the merv_tpu script's keys, rates and times finite and > 0, the card
    named) and each process's launches against its shapes."""
    import concurrent.futures

    import torch

    from merv_tpu_torch.bench import vidlm_prefix

    kind_name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    shutil.rmtree(BENCH_ROOT, ignore_errors=True)
    os.makedirs(BENCH_ROOT)
    randinit = vidlm_prefix.ROOT / "runs" / vidlm_prefix.RUN
    write_run_dir(randinit, dev, seed)
    export_args, export_want = export_inputs(os.path.join(BENCH_ROOT, "export"), seed)
    preprocess_args = preprocess_inputs(os.path.join(BENCH_ROOT, "preprocess"), seed)
    base_env = dict(os.environ, **BENCH_ENV)
    for name in SWITCHES:
        base_env.pop(name, None)

    def prefix_mode():
        t = time.perf_counter()
        max_new, slots = int(os.environ.get("BENCH_VP_MAX_NEW", "32")), int(os.environ.get("BENCH_VP_SLOTS", "4"))
        out = vidlm_prefix.run_mode("engine_shared", max_new, slots)
        return out, out["launches"], time.perf_counter() - t, ""

    jobs = {label: (lambda a=args, e=env: run_bench_process(a, dict(base_env, **e))) for label, (args, env) in
            BENCH_RUNS.items()}
    jobs["vidlm_prefix_engine_shared"] = prefix_mode
    jobs["export_towers"] = lambda: run_tool_process(export_args, base_env)
    jobs["preprocess"] = lambda: run_tool_process(preprocess_args, base_env)
    torch.cuda.empty_cache()  # this process's cached blocks, for the benches' processes
    results = {}
    with concurrent.futures.ThreadPoolExecutor(BENCH_PARALLEL) as pool:
        # the longest first (tower_attn's child processes, serving's four, vidlm_prefix's load_vid): the
        # phase's wall is then about the longest job's
        order = sorted(jobs, key=lambda label: BENCH_FIRST.index(label) if label in BENCH_FIRST else len(BENCH_FIRST))
        futures = {pool.submit(jobs[label]): label for label in order}
        for fut in concurrent.futures.as_completed(futures):
            label = futures[fut]
            out, launches, secs, err = fut.result()  # a failed process raises here and fails the phase
            results[label] = dict(line=out, launches=launches, process_s=secs)
            log(f"[bench] {label}: {secs:.1f} s; {json.dumps(out)[:1500] if out else err[-300:]}")

    checked = {}
    for label, r in results.items():
        out, launches = r["line"], r["launches"]
        if label in ("export_towers", "preprocess"):
            continue
        kind = label.split("_")[0] if label.startswith(("decode", "vidlm")) else label
        kind = {"vidlm": "vidlm_prefix", "tower_attn_more": "tower_attn"}.get(kind, kind)
        check_line(label, kind, out, kind_name)
        if kind == "serving":
            for ph, part in out["phases"].items():
                checked[f"serving_{ph}"] = check_launches(f"serving/{ph}", part["launches"],
                                                          bench_expected("serving_phase", part))
        elif kind == "tower_attn":
            for row in out["rows"]:
                checked[f"tower_attn_{row['impl']}"] = check_launches(f"tower_attn/{row['impl']}", row["launches"],
                                                                      bench_expected("tower_attn_row", row))
        elif kind == "vidlm_prefix":
            k = launches
            if not (k["small_attention_kt"] > 0 and k["small_attention_kt"] % (2 * TOWER_LAYER_CALLS) == 0
                    and k["layer_norm"] == TOWER_LN * k["small_attention_kt"] // (2 * TOWER_LAYER_CALLS)
                    and all(k[n] > 0 for n in ("flash_attention_forward", "int8_linear", "decode_attention"))
                    and all(k[n] == 0 for n in ("flash_attention_backward", "small_attention",
                                                "packed_temporal_attention", "fused_vit_attn_block",
                                                "fused_vit_attn_block_d72"))):
                raise RuntimeError(f"[bench] {label}: launches {k}: K1 and K6 a whole number of prefills, K2 / K4 / "
                                   "K5 launched, nothing else")
            checked[label] = k
        else:
            checked[label] = check_launches(label, launches, bench_expected(kind, out))
    exported = check_export(os.path.join(BENCH_ROOT, "export"), export_want)
    converted = check_preprocess(os.path.join(BENCH_ROOT, "preprocess"))
    shutil.rmtree(BENCH_ROOT, ignore_errors=True)
    shutil.rmtree(randinit, ignore_errors=True)
    shutil.rmtree(vidlm_prefix.ROOT / "eval_result" / vidlm_prefix.RUN, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"[bench] phase 6: {wall:.1f} s; every line held its keys and its launches; exported {exported}, "
        f"preprocess converted {converted} images")
    return dict(results=results, launches=checked, exported=exported, converted=converted, wall_s=wall)


def bench_launches(bench: dict, name: str) -> dict:
    """A kernel's launches in each of phase 6's runs (per serving phase and tower_attn impl)."""
    return {label: k.get(name, 0) for label, k in bench["launches"].items()}


# ---------------------------------------------------------------------------

# every kernel library: K2, K3, K1, B3, B6, B5, K4, K5 and K6
COMPILED_LIBS = ("flash_fwd", "flash_bwd", "small_attention_kt", "small_attention", "fused_vit_block",
                 "packed_temporal", "int8_linear", "decode_attention", "layer_norm")
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UBLKCP")


def compile_report() -> dict:
    """What was compiled for each kernel library: each kernel's registers,
    spills and static shared memory as ``ptxas -v`` reported them at the
    build, and, where ``cuobjdump`` exists, the count of ``HGMMA`` (wgmma),
    ``HMMA`` (mma.sync), ``UTMALDG`` (TMA tensor load) and ``UBLKCP`` (1-D bulk
    copy) instructions in each library's SASS. ptxas's warnings (a wgmma
    serialised, a setmaxnreg ignored) are kept too. Logged on lines of their
    own."""
    import re

    from merv_tpu_torch.ops import _build

    cuobjdump = shutil.which("cuobjdump") or next(
        (p for p in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"),)
         if os.path.exists(p)), None)
    def kernel_name(mangled):
        short = re.search(r"([a-z_]+_kernel)I((?:L[ib]\d+E)+)E", mangled)
        if short:  # template arguments: ints (Li128E) or bools (Lb1E)
            args = [n if k == "i" else ("false", "true")[int(n)] for k, n in re.findall(r"L([ib])(\d+)E", short.group(2))]
            return f"{short.group(1)}<{', '.join(args)}>"
        return re.search(r"([a-z_]+_kernel)", mangled).group(1) if "_kernel" in mangled else mangled

    report = {}
    for lib in COMPILED_LIBS:
        kernels, current, warnings = {}, None, []
        for line in _build.build_log(lib).splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                warnings.append(line.strip())
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = kernel_name(m.group(1))
                kernels[current] = {}
                continue
            if current is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                kernels[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                kernels[current]["registers"] = int(m.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                kernels[current]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
        sass = None
        if cuobjdump is not None:
            dump = subprocess.run([cuobjdump, "-sass", str(_build.BUILD_DIR / f"lib{lib}.so")], capture_output=True,
                                  text=True, timeout=120)
            if dump.returncode == 0:
                sass = {op: len(re.findall(rf"\b{op}\b", dump.stdout)) for op in SASS_OPS}
                # each kernel's own counts (a library holds several instances: K1 / B3 one a head dim)
                for part in re.split(r"\n\s*Function : ", dump.stdout)[1:]:
                    name = kernel_name(part.split(None, 1)[0])
                    kernels.setdefault(name, {})["sass"] = {op: len(re.findall(rf"\b{op}\b", part)) for op in SASS_OPS}
        report[lib] = dict(kernels=kernels, sass=sass, ptxas_warnings=warnings)
        for name, k in kernels.items():
            log(f"[compile] {lib}: {name}: {k.get('registers')} registers, {k.get('spill_stores')} bytes spill stores, "
                f"{k.get('spill_loads')} bytes spill loads, {k.get('static_smem_bytes')} bytes static shared memory; "
                f"SASS {k.get('sass', 'not measured')}")
        for line in warnings:
            log(f"[compile] {lib}: ptxas: {line}")
        log(f"[compile] {lib}: SASS instruction counts {sass}" if sass is not None else
            f"[compile] {lib}: cuobjdump not found (or failed): {' / '.join(SASS_OPS)} counts not measured")
    return report


KERNELS = {
    "small_attention_kt": dict(source="merv_tpu_torch/csrc/small_attention_kt.cu",
                               replaces="merv_tpu/ops/attention.py:540", main_case="dinov2_frames"),
    "flash_attention_forward": dict(source="merv_tpu_torch/csrc/flash_fwd.cu",
                                    replaces="merv_tpu/ops/attention.py:376", main_case="llama_cache_prefill"),
    "flash_attention_backward": dict(source="merv_tpu_torch/csrc/flash_bwd.cu",
                                     replaces="merv_tpu/ops/attention.py:791", main_case="llama_training"),
    "small_attention": dict(source="merv_tpu_torch/csrc/small_attention.cu",
                            replaces="merv_tpu/ops/attention.py:473", main_case="dinov2_frames",
                            request="tower_attn_xla+temporal_kernel"),
    "packed_temporal_attention": dict(source="merv_tpu_torch/csrc/packed_temporal.cu",
                                      replaces="merv_tpu/ops/attention.py:622", main_case="languagebind_temporal",
                                      request="tower_attn_xla+temporal_kernel"),
    "fused_vit_attn_block": dict(source="merv_tpu_torch/csrc/fused_vit_block.cu",
                                 replaces="merv_tpu/ops/fused_vit_block.py:135", main_case="dinov2",
                                 request="fused_block"),
    # B6's head-dim-72 instance (SigLIP so400m), counted apart; its launches come from phase 5b's align run
    "fused_vit_attn_block_d72": dict(source="merv_tpu_torch/csrc/fused_vit_block.cu",
                                     replaces="merv_tpu/ops/fused_vit_block.py:135", main_case="so400m_frames",
                                     pretrain=True),
    # K4 and K5 replace fused XLA work of merv_tpu's int8 serving, not a Pallas kernel: the int8 Linear's product
    # and the attention over the (dequantized) cache at T = 1; their launches come from phase 4f's request
    "int8_linear": dict(source="merv_tpu_torch/csrc/int8_linear.cu", replaces="merv_tpu/nn/core.py:128",
                        main_case="qkvo_m1", int8=True),
    "decode_attention": dict(source="merv_tpu_torch/csrc/decode_attention.cu",
                             replaces="merv_tpu/models/backbones/llm/transformer.py:402", main_case="b1_int8",
                             int8=True),
    # K5 with its LSE output: one call a cache shard of the sequence-parallel cache (merv_tpu's sharded body,
    # ops/ring_attention.py:462-483); its launches come from phase 4i's two-rank eval run
    "decode_attention_lse": dict(source="merv_tpu_torch/csrc/decode_attention.cu",
                                 replaces="merv_tpu/ops/ring_attention.py:470", main_case="b1_bf16_1120", sp=True),
    # K6 replaces XLA's fused LayerNorm (merv_tpu leaves it to XLA), not a Pallas kernel; its launches come from the
    # frozen towers of phase 5's align run
    "layer_norm": dict(source="merv_tpu_torch/csrc/layer_norm.cu", replaces="merv_tpu/nn/core.py:168",
                       main_case="align_languagebind"),
}
SERVING_KERNELS = ("small_attention_kt", "flash_attention_forward")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--flash-only", action="store_true",
                    help="build, then run only the K2 and K3 kernel cases and print them (no result line): "
                         "for comparing two versions of the flash kernels within one call")
    ap.add_argument("--small-only", action="store_true",
                    help="build, then run only the K1 and B3 kernel cases and print them (no result line): "
                         "for comparing two versions of the whole-sequence kernels within one call")
    ap.add_argument("--engine-only", action="store_true",
                    help="build, then run only phase 4e (the serving engine) and print its numbers (no result line)")
    ap.add_argument("--int8-only", action="store_true",
                    help="build, then run only K4's and K5's kernel cases and print them (no result line): for "
                         "comparing two versions of the int8 and decode kernels within one call")
    ap.add_argument("--decode-step-only", action="store_true",
                    help="build, then time only the B=1 decode step of Llama-2-7B's widths at 8 layers, bf16 and int8 "
                         "(no result line): for comparing two versions of K4 and K5 in the step within one call")
    ap.add_argument("--int8-serving-only", action="store_true",
                    help="build, then run only phase 4f (int8 serving) and print its numbers (no result line)")
    ap.add_argument("--families-only", action="store_true",
                    help="build, then run only phase 3's cases at the LLM families' shapes, the packed-layout check "
                         "and phase 4g (the LLM families) and print their numbers (no result line)")
    ap.add_argument("--zoo-only", action="store_true",
                    help="build, then run only K1's and B3's head-dim-72 cases and phase 4h (the vision zoo) and print "
                         "their numbers (no result line)")
    ap.add_argument("--pretrain-only", action="store_true",
                    help="build, then run only B6's head-dim-72 cases and phase 5b (the pretrain entry point) and "
                         "print their numbers (no result line)")
    ap.add_argument("--bench-only", action="store_true",
                    help="build, then run only phase 6 (the bench and tooling modules) and print their lines (no result "
                         "line)")
    ap.add_argument("--sp-only", action="store_true",
                    help="build, then run only phase 4i (sequence-parallel serving: K5 with its LSE on cache shards, the "
                         "ring on 8,192 tokens, eval_openended --mesh_seq 2 as two ranks) and print its numbers (no "
                         "result line)")
    ap.add_argument("--sp-worker", metavar="OUT_DIR", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-only", action="store_true",
                    help="build, then run only phase 3's cases at tensor-parallel serving's shard shapes and phase 4j "
                         "(tensor = 2 serving as two ranks over gloo beside a world-1 reference) and print their "
                         "numbers (no result line)")
    ap.add_argument("--tp-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--train-parallel-only", action="store_true",
                    help="build, then run only phase 5c (multi-rank training: the gloo probe, fsdp-full-shard, "
                         "--mesh_seq 2 and --mesh_pipe 2 as two ranks on the card, the memory proof) and print its "
                         "numbers (no result line)")
    ap.add_argument("--train-parallel-worker", metavar="OUT_DIR", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--layer-norm-only", action="store_true",
                    help="build, then run only K6's kernel cases and print them (no result line): for comparing two "
                         "versions of the LayerNorm kernel within one call")
    ap.add_argument("--tower-only", action="store_true",
                    help="build, then run only the towers' B3, B5 and B6 kernel cases and print them (no result "
                         "line): for comparing two versions of the towers' opt-in kernels within one call")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 2
    if args.sp_worker is not None:  # one rank of phases 4i(c) and 4j, started by torch.distributed.run
        return sp_worker(args.sp_worker, args.seed)
    if args.tp_worker:  # one rank of phase 4j alone (--tp-only), started by torch.distributed.run
        tensor_worker(args.seed)
        return 0
    if args.train_parallel_worker is not None:  # one rank of phase 5c, started by torch.distributed.run
        return train_parallel_worker(args.train_parallel_worker)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from merv_tpu_torch.ops import _build

    t = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t
    log(f"[build] {len(logs)} kernel libraries built with nvcc (sm_90a) in {build_s:.1f} s")
    compiled = compile_report()

    if args.flash_only:
        cases = kernel_cases(dev, args.seed, k1=False) + backward_cases(dev, args.seed)
        keys = ("kernel", "case", "ms", "device_ms", "library_ms", "library_device_ms", "bound_ms",
                "worst_share_of_limit")
        log(json.dumps({"flash_cases": [{k: c.get(k) for k in keys} for c in cases]}))
        return 0
    if args.small_only:
        cases = (kernel_cases(dev, args.seed, k2=False) + tower_kernel_cases(dev, args.seed, b3_only=True)
                 + head_dim_72_cases(dev, args.seed))
        keys = ("kernel", "case", "ms", "graph_ms", "device_ms", "library_ms", "library_graph_ms",
                "library_device_ms", "bound_ms", "worst_share_of_limit")
        log(json.dumps({"small_cases": [{k: c.get(k) for k in keys} for c in cases]}))
        return 0
    if args.int8_only:
        cases = int8_kernel_cases(dev, args.seed)
        keys = ("kernel", "case", "shape", "ms", "graph_ms", "cold_graph_ms", "plain_ms", "library_ms",
                "library_graph_ms", "library_cold_graph_ms", "bound_ms", "bound_by", "worst_share_of_limit",
                "max_abs_err", "splits", "cluster", "residency", "cold_copies", "launches_per_call")
        log(json.dumps({"int8_cases": [{k: c.get(k) for k in keys} for c in cases]}))
        return 0
    if args.decode_step_only:
        log(json.dumps({"decode_step": decode_step_probe(dev, args.seed)}))
        return 0
    if args.int8_serving_only:
        with switches({}):
            out = int8_path(dev, args.seed, args.max_new_tokens)
        log(json.dumps({"int8_serving": {k: out[k] for k in ("wall_s", "load_s", "weights", "step_ms", "request")},
                        "chunks": {g: {k: v for k, v in r.items() if k != "profiled_replay"}
                                   for g, r in out["chunks"]["chunks"].items()},
                        "run": {k: out["run"][k] for k in ("process_wall_s", "summary")}}))
        return 0
    if args.engine_only:
        with switches({}):
            engine = engine_path(dev, args.seed)
        log(json.dumps({"engine": {"chunks": engine["chunks"], "checks": engine["checks"],
                                   "runs": [{k: r[k] for k in ("label", "process_wall_s", "summary")}
                                            for r in engine["runs"]]}}))
        return 0
    if args.families_only:
        with switches({}):
            cases = family_kernel_cases(dev, args.seed)
            packed = packed_check(dev, args.seed, args.max_new_tokens)
            families = families_path(dev, args.seed, args.max_new_tokens)
        keys = ("kernel", "case", "shape", "graph_ms", "cold_graph_ms", "library_graph_ms", "library_cold_graph_ms",
                "bound_ms", "bound_by", "plain_ms", "library_ms", "worst_share_of_limit", "splits", "cluster")
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "families.json"), "w") as f:
            json.dump(dict(device=kind, nvidia_smi=smi, cases=cases, packed_check=packed, families_path=families), f,
                      indent=1, default=str)
        log(json.dumps({"family_cases": [{k: c.get(k) for k in keys} for c in cases]}))
        log(json.dumps({"packed": {k: {kk: vv for kk, vv in v.items() if kk != "top_kernels"} if isinstance(v, dict)
                                   else v for k, v in packed.items()}}))
        log(json.dumps({"families": family_summary(families)}))
        return 0
    if args.zoo_only:
        with switches({}):
            cases = head_dim_72_cases(dev, args.seed)
            zoo = zoo_path(dev, args.seed, args.max_new_tokens)
        keys = ("kernel", "case", "shape", "ms", "graph_ms", "device_ms", "library_ms", "library_graph_ms",
                "library_device_ms", "plain_ms", "bound_ms", "bound_by", "worst_share_of_limit")
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "zoo.json"), "w") as f:
            json.dump(dict(device=kind, nvidia_smi=smi, compiled=compiled, cases=cases, zoo_path=zoo), f, indent=1,
                      default=str)
        log(json.dumps({"d72_cases": [{k: c.get(k) for k in keys} for c in cases]}))
        log(json.dumps({"zoo": zoo_summary(zoo)}, default=str))
        return 0
    if args.pretrain_only:
        with switches({}):
            cases = fused_d72_cases(dev, args.seed)
            pretrain = pretrain_path(dev, args.seed)
        keys = ("kernel", "case", "shape", "ms", "graph_ms", "plain_ms", "yardstick_ms", "yardstick_graph_ms",
                "bound_ms", "bound_by", "worst_share_of_limit", "kernel_device_ms")
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "pretrain.json"), "w") as f:
            json.dump(dict(device=kind, nvidia_smi=smi, compiled=compiled, cases=cases, pretrain_path=pretrain), f,
                      indent=1, default=str)
        log(json.dumps({"d72_b6_cases": [{k: c.get(k) for k in keys} for c in cases]}))
        log(json.dumps({"pretrain": {run: {k: pretrain[run][k] for k in (
            "step_s", "micro_step_s", "losses", "launches", "peak_memory_gib", "async_saves",
            "first_micro_step_loss", "first_micro_step_rel_diff", "planted_fault_rel_diff", "so400m_rel_l2",
            "b6_held_at_path_shapes",
            "wall_s", "process_s")} for run in ("align", "finetune", "resume")}}, default=str))
        return 0
    if args.bench_only:
        with switches({}):
            bench = bench_path(dev, args.seed)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "bench.json"), "w") as f:
            json.dump(dict(device=kind, nvidia_smi=smi, bench_path=bench), f, indent=1, default=str)
        log(json.dumps({"bench": {label: dict(r["line"] or {}, process_s=r["process_s"]) for label, r in
                                  bench["results"].items()}, "wall_s": bench["wall_s"]}, default=str))
        return 0
    if args.sp_only:
        with switches({}):
            sp = sp_path(dev, args.seed)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "sp.json"), "w") as f:
            json.dump(dict(device=kind, nvidia_smi=smi, sp_path=sp), f, indent=1, default=str)
        keys = ("kernel", "case", "shape", "ms", "graph_ms", "cold_graph_ms", "no_lse_graph_ms", "lse_graph_ms",
                "no_lse_cold_graph_ms", "lse_cold_graph_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "worst_share_of_limit")
        log(json.dumps({"sp_k5_cases": [{k: c.get(k) for k in keys} for c in sp["k5_cases"]]}))
        log(json.dumps({"sp_ring": sp["ring"]}, default=str))
        log(json.dumps({"sp_entry": sp["entry"]}, default=str))
        return 0
    if args.tp_only:
        with switches({}):
            tp = tensor_path(dev, args.seed)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "tp.json"), "w") as f:
            json.dump(dict(device=kind, nvidia_smi=smi, tensor_path=tp), f, indent=1, default=str)
        keys = ("kernel", "case", "shape", "ms", "graph_ms", "cold_graph_ms", "plain_ms", "library_ms",
                "library_graph_ms", "library_cold_graph_ms", "bound_ms", "bound_by", "worst_share_of_limit", "splits",
                "cluster")
        log(json.dumps({"tp_cases": [{k: c.get(k) for k in keys} for c in tp["cases"]]}))
        c = tp["checks"]
        log(json.dumps({"tp": {k: c[k] for k in ("first_token_logits_rel_l2", "agreement", "request_wall_vs_world1",
                                                 "engine_wall_vs_world1", "ranks_process_wall_s")},
                        "ranks": [{k: r[k] for k in ("weight_share", "int8_weight_share", "cache_share",
                                                     "step_collectives")} for r in c["ranks"]],
                        "stepwise": {k: c["stepwise"][k] for k in ("logits_rel_l2_max", "greedy_token_agreement")},
                        "wall_s": tp["wall_s"]}, default=str))
        return 0
    if args.train_parallel_only:
        with switches({}):
            tp = train_parallel_path(dev, args.seed)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "train_parallel.json"), "w") as f:
            json.dump(dict(device=kind, nvidia_smi=smi, train_parallel_path=tp), f, indent=1, default=str)
        log(json.dumps({"train_parallel": {k: tp[k] for k in (
            "gloo_probe", "loss_rel", "norm_rel", "planted", "pp_loss_rel", "pp_norm_rel", "bytes_share",
            "pp_layer_share", "sp_grad_rel", "resume", "launches", "wall_s")}}, default=str))
        return 0
    if args.layer_norm_only:
        cases = layer_norm_cases(dev, args.seed)
        keys = ("kernel", "case", "shape", "eps", "ms", "graph_ms", "plain_ms", "plain_graph_ms", "library_ms",
                "library_graph_ms", "bound_ms", "roofline_share", "worst_share_of_limit", "bit_equal_share", "max_ulps")
        log(json.dumps({"layer_norm_cases": [{k: c.get(k) for k in keys} for c in cases]}))
        return 0
    if args.tower_only:
        cases = tower_kernel_cases(dev, args.seed, by_launch=True)
        keys = ("kernel", "case", "ms", "graph_ms", "library_ms", "library_graph_ms", "yardstick_ms",
                "yardstick_graph_ms", "bound_ms", "worst_share_of_limit", "attention_stage_ms", "kernel_device_ms")
        log(json.dumps({"tower_cases": [{k: c.get(k) for k in keys} for c in cases]}))
        return 0

    ends = {"build": build_s}  # each phase's end, in seconds since the build began

    def timed(name, fn, *a):
        out = fn(*a)
        ends[name] = time.perf_counter() - t
        log(f"[time] {name} ended at {ends[name]:.1f} s")
        return out

    with switches({}):  # every phase sets the switches it runs under
        cases = []
        for fn in (kernel_cases, backward_cases, tower_kernel_cases, fused_d72_cases, head_dim_72_cases,
                   int8_kernel_cases, family_kernel_cases, tensor_kernel_cases, layer_norm_cases):
            cases += timed(fn.__name__, fn, dev, args.seed)
        main = timed("main_path", main_path, dev, args.seed, args.max_new_tokens)
        loaded = timed("loaded_path", loaded_path, dev, args.seed, args.max_new_tokens,
                       os.path.join("runs", "chip_smoke_quickstart"))
        evals = timed("eval_path", eval_path, dev, args.seed)
        engine = timed("engine_path", engine_path, dev, args.seed)
        sp = timed("sp_path", sp_path, dev, args.seed)
        cases += sp["k5_cases"]
        int8 = timed("int8_path", int8_path, dev, args.seed, args.max_new_tokens,
                     main["decode_graph"]["greedy"]["graph"]["ms_per_step"], loaded["request"]["tokens"])
        packed = timed("packed_check", packed_check, dev, args.seed, args.max_new_tokens)
        families = timed("families_path", families_path, dev, args.seed, args.max_new_tokens)
        zoo = timed("zoo_path", zoo_path, dev, args.seed, args.max_new_tokens)
        train = timed("train_path", train_path, dev, args.seed, os.path.join("runs", "chip_smoke_align"))
        pretrain = timed("pretrain_path", pretrain_path, dev, args.seed)
        train_parallel = timed("train_parallel_path", train_parallel_path, dev, args.seed)
        bench = timed("bench_path", bench_path, dev, args.seed)

    kernels = []
    for name, meta in KERNELS.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = next(c for c in mine if c["case"] == meta["main_case"])
        if "request" in meta:  # the towers' opt-in kernels: launches of the request served with their switch
            launches = main["switched_requests"][meta["request"]]["launches"][name]
        elif meta.get("int8"):  # K4 and K5: the int8 request of phase 4f (training runs neither)
            launches = int8["request"]["launches"][name]
        elif meta.get("pretrain"):  # B6 at head dim 72: phase 5b's align run
            launches = pretrain["align"]["launches"][name]
        elif meta.get("sp"):  # K5 with its LSE: rank 0 of phase 4i's sequence-parallel eval run
            launches = sp["entry"]["runs"]["group"]["ranks"][0]["launches"].get(name, 0)
        else:
            launches = train["launches"][name]
        if launches <= 0:
            raise RuntimeError(f"kernel {name} was not launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=launches, launches_serving=main["launches"].get(name, 0),
            launches_loaded=loaded["launches"].get(name, 0),
            launches_eval={**{r["label"]: r["launches"].get(name, 0) for r in evals["runs"]},
                           **{f"shared_check_{k}": evals["shared_vs_batch"][k]["launches"].get(name, 0)
                              for k in SHARED_CHECK_LAUNCHES}},
            launches_engine={**{r["label"]: r["summary"]["launches"].get(name, 0) for r in engine["runs"]},
                             "int8": int8["run"]["summary"]["launches"].get(name, 0),
                             FAMILY_FULL + "_int8": families["models"][FAMILY_FULL]["serve_run"]["summary"]["launches"]
                             .get(name, 0)},
            launches_families={**{label: m["request"]["launches"].get(name, 0) for label, m in families["models"].items()},
                               FAMILY_FULL + "_int8": families["models"][FAMILY_FULL]["int8_request"]["launches"]
                               .get(name, 0)},
            launches_zoo={label: r["request"]["launches"].get(name, 0) for label, r in zoo["requests"].items()},
            launches_pretrain={run: pretrain[run]["launches"].get(name, 0) for run in ("align", "finetune", "resume")},
            launches_train_parallel={run: counts.get(name, 0) for run, counts in train_parallel["launches"].items()},
            launches_bench=bench_launches(bench, name),
            launches_sp={**{f"{label}_rank{r['rank']}": r["launches"].get(name, 0)
                            for label, run in sp["entry"]["runs"].items() for r in run["ranks"]},
                         "ring_blocks_in_process": sp["ring_launches"].get(name, 0)},
            launches_tp={**{f"{run}_rank{r['rank']}": (r["request"] if run == "request" else r["int8_engine"]
                                                       if run == "int8_engine" else r["engine"][run])["launches"]
                            .get(name, 0) for r in sp["tensor"]["ranks"]
                            for run in ("request", "gamma0", "gamma2", "int8_engine")}},
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"], cases=mine,
            **{key: head[key] for key in ("yardstick_ms", "device_ms", "library_device_ms", "graph_ms",
                                          "library_graph_ms", "yardstick_graph_ms") if key in head},
        ))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(device=kind, nvidia_smi=smi, build_s=build_s, phase_end_s=ends, compiled=compiled, kernels=kernels,
                       main_path=main, loaded_path=loaded, eval_path=evals, engine_path=engine, int8_path=int8,
                       packed_check=packed, families_path=families, zoo_path=zoo, train_path=train,
                       pretrain_path=pretrain, train_parallel_path=train_parallel, bench_path=bench, sp_path=sp),
                  f, indent=1, default=str)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
