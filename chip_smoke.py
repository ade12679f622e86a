#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: its main paths on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero with no result):
1. probe   - the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
             requires compute capability 9.0 (Hopper).
2. build   - builds every kernel of the paths from csrc/ with nvcc for
             sm_90a, one nvcc per source, all at once; prints ptxas's
             registers and spills.
3. kernel  - each kernel against its plain PyTorch version on the card at
             the shapes the paths give it. Flash attention: bf16 against
             the plain version in fp32 at 2e-2 at the Pi-0 prefill over 1
             and over 4 rows (the batched eval's), the naive step, the
             pool64 prefill, a ragged GQA shape and the smallest head_dim;
             fp32 (3xTF32, TF32 off in the plain version) at 1e-5 at each
             of those shapes and at a batched baseline bucket
             [4,8,281,256], with q and k x0.3 and x1.0; each the same bits
             on a second call, its launch geometry logged; timed at the
             Pi-0 prefill shape (fp32 and bf16, the kernels line's entry),
             at the naive step's 281 rows and the bucket of 4 (fp32) and
             at the pool64 prefill (bf16), each beside its plain version,
             SDPA and its bound (fp32 against the TF32 peak over three
             products). The int4 matmul: bit for
             bit (bound 1e-6 relative) at every w4a8 linear of the Pi-0
             step, the same bits on a second call, its split of K (S) and
             grid logged; then it, its plain version and a bf16 matmul of
             the dense weight timed at the vlm gate, the vlm down
             projection and the action gate.
             kernel-int8: the int8 matmul at the 13 (M, K, N) of the int8
             step and at the action linears' M 8, 16 and 32 (the decode of
             buckets of 2, 4 and 8), fp32 x within 1e-5 of the largest
             output and bf16 x within one bf16 rounding of each output,
             the same bits on a
             second call, its split of K (S) and grid logged; then it, its
             plain version, the library's int8 weight-only product
             (torch._weight_int8pack_mm, bf16 scales) and a bf16 matmul of
             the dequantized weight timed at the action gate and down
             projection shapes; at every shape its bound and, in a CUDA
             graph, the library call and the dense matmul. Every kernel is
             timed two ways: CUDA events around 50 eager launches (which
             for a short kernel time its wrapper's host work) and inside a
             CUDA graph (the device's time alone).
3b. kernel-text - flash attention at Pi-0's text prefill: 276 query rows
             over a layer's slice of the stacked cache buffer of 296 keys,
             the last 20 masked (random there), at batch 1 and at batch 2
             with the second row right-padded; fp32 (2e-4) and bf16 (2e-2),
             the soft clamp 50 and off, each the same bits on a second call;
             at small logits (|logit| < 1) and with q and k x3 (the largest
             |logit| ~45), where clamp 50 and off must differ by more than
             10x the tolerance;
             timed at batch 1 in bf16 with both clamps beside the plain
             version, the bound and, for the clamp off, SDPA.
4. serve   - the port's ActionServer at the full bridge.yaml width with the
             blurr preset (bf16, prefix KV cache, one flow step) and
             joint.config.use_flash_attn set, random weights drawn on the
             card; 3 requests through the port's
             blurr_tpu_torch.serving.client.ActionClient. Each
             answer must be a finite [4, 7] chunk in [-1, 1], and the flash
             kernel must have launched exactly 17 times per control step
             (18 layers, the last computes only K/V); one step under
             torch.profiler gives the step's device time and the flash
             kernel's share.
5. model   - the same weights and inputs through one control step with the
             kernel and with the plain attention; the actions must agree.
5b. serve-checkpoint - the served weights written with
             checkpoint.save_torch_checkpoint (fp32, the reference's .pt
             layout) to a temporary directory, a second ActionServer
             started from that path (blurr preset), the file deleted; its
             parameters must equal the drawn ones and its 3 answers must be
             the same bits as the first server's. Logs the file's size and
             the write and load times.
5c. serve-reload - while that .pt exists: a blurr server drawn from
             another seed takes an atomic reload of it through
             scripts/serve_ctl_torch.py, then a drop_first one, while a
             client thread sends requests the whole time: no request fails,
             the parameters are the written ones bit for bit after each;
             the reload seconds, the longest request across each and the
             peak memory of each mode logged. A bridge_tiny.yaml .pt is
             refused (ValueError) with the weights still serving; a
             drop_first reload of a missing path leaves "no weights
             loaded"; an atomic reload recovers. K1 17 times a request.
5d. serve-batched - bridge.yaml blurr with max_batch 8 ('pow2', a window
             of BATCH_WINDOW_MS): the buckets 1, 2, 4 and 8 warmed (seconds
             each); K1 at [2|8,8,277,256] against its plain version within
             BF16_TOL, the same bits twice, its grid logged; 1, 2, 4 and 8
             concurrent clients, BATCHED_REQUESTS each: chunks/s, client
             p50 / p99, batches, occupancy and padding from stats(), every
             answer a finite [4, 7] chunk in [-1, 1], K1 17 times a batch;
             each row of a bucket of 5 against a batch-1 step on its inputs
             and noise row within BATCHED_TOL; one step per bucket under
             torch.profiler; then 'max' at 3 clients: padded slots = 8 x
             batches - live.
5e. serve-backpressure - max_batch 2, max_queue 2, 8 concurrent clients:
             rejected_total > 0, each rejection an "Overloaded" error at its
             client, every other answer a good chunk, K1 17 times a batch.
6. small   - a small fp32 model (bridge_tiny widths, an 80-token prefix so
             the prefill takes the kernel) on the card against the same
             weights on the CPU, where the port runs its plain versions
             (the CPU tests hold those against the JAX package).
6b. serve-baseline - bridge.yaml with the baseline preset (fp32, no prefix
             cache, 10 flow steps) and joint.config.use_flash_attn set,
             random weights drawn on the card, 3 requests through
             ActionClient, checked as in serve; K1's fp32 kernel must launch
             exactly 180 times per control step (18 layers x 10 flow steps,
             281 rows each); the model-step median and one step under
             torch.profiler (device time, K1's share); the naive step
             against the cached one (the prefix_cache preset) on the same
             weights, inputs and noise within BASELINE_TOL, both timed.
6c. small-adaLN-Zero - the small fp32 model with an adaLN-Zero action
             expert, card against CPU, cached (2 launches of K1) and naive
             (30).
7. serve-w4a8 - bridge_pool64_w4a8_steps1.yaml at full width (vlm and action
             mixtures w4a8 through the int4 kernel, SigLIP w8a8), with
             joint.config.use_flash_attn set: random bf16 weights drawn on
             the card and quantized there, then 3 requests through
             ActionClient. Each answer must be a finite [4, 7] chunk in
             [-1, 1]; the int4 kernel must launch exactly 370 times and the
             flash kernel 17 times per control step; the resident weights
             must stay under 3.0 GB; one step under torch.profiler gives
             the step's device time and the int4 and flash kernels' shares.
7b. serve-batched-w4a8 - the same config with max_batch 4: the buckets 1,
             2 and 4 warmed, 4 concurrent clients; K2 370 and K1 17 times a
             batch; every K2 shape the buckets give that phase 3 did not
             hold is held bit-equal against the plain route.
8. small-w4a8 - the small fp32 model quantized w4a8 (SigLIP w8a8) on the
             card against the same quantized weights on the CPU.
9. serve-int8 - bridge_pool64_steps2.yaml at full width with
             action_quantization.cache_fp_weight set false (the int8 {q, s}
             tier: action expert and action encoder through the int8
             kernel, the int8 KV cache) and joint.config.use_flash_attn set:
             random bf16 weights drawn on the card and quantized there, then
             3 requests through ActionClient, checked as serve-w4a8; the
             int8 kernel must launch exactly 380 times per control step, the
             flash kernel 17 times, the int4 kernel never, and every decode
             must read an int8 prefix cache; one step under torch.profiler
             gives the step's device time and the int8 and flash kernels'
             shares.
10. serve-int8-cached - the preset as shipped (cache_fp_weight true: the
             action expert holds a bf16 copy of its int8 weights), the same
             checks and profile, with 0 launches of the int8 kernel.
11. small-int8 - the small fp32 model with the int8 {q, s} action expert
             and the int8 KV cache (clip 1.0, bf16), card against CPU; then
             again with the card given the CPU's rounding wherever a cached
             K/V value or an int8 kernel input rounds the other way, held
             to the fp32 bound.
12. kernel-experiments - the kernels of the experiment harnesses against
             their plain versions at every harness shape, bit for bit: the
             w8a8 product K4 (row-major at M 8 and 32, K 4096, N 11264;
             block-major at the 4 shapes of the int8 block-major harness),
             the split-half int4 product K5 signed and biased (M 8 and 32,
             each the same bits on a second call, its grid and split of K/2
             (S) and ptxas's registers and spills logged),
             K2 at one group on the adjacent-row (bitcast) packing (M 8, 32,
             96); the fused GeGLU FFN K6 at (280, 2048, 16384) within one
             bf16 step at its largest output and the same bits on a second
             call, the grid of its two phases (phase 1 gate, up and GeGLU
             on wgmma, a through L2; phase 2 the down product, K split into
             S slices in a cluster) and ptxas's registers and spills logged;
             K4 the same bits on a second call, its grid and split of K (S)
             logged. Each timed as the other kernels: K4 at all six harness
             shapes beside torch._int_mm and its bound (and, for
             information, _int_mm on a column-major copy of the weight), K5
             at both M signed and biased beside K4 at the same shape, K6
             beside three bf16 matmuls, and one K6 call's device time split
             between its two phases under torch.profiler.
13. experiments - the two experiment entry points run as a user runs them
             (bench_lowbit_matmul, bench_fused_ffn at 18 layers), with the
             counts set to 0 just before: K4, K5, K2 and K6 must each launch.
14. eval-agent - the port's EvalAgent at the full bridge.yaml width (blurr
             preset, joint.config.use_flash_attn set, random weights drawn
             on the card) on the fake env (480x640 frames resized on the
             host by the Lanczos ladder, whose rung is logged): 2 episodes
             of 12 env steps, act_steps 4. Both summary lines; K1 17 times
             per control step; every dispatched chunk bit-equal to
             infer_action called directly on the same inputs and noise; the
             steady p50 and the peak memory beside the card's name and power
             limit; then the agent's control step timed 10 times on one
             frame (median, min, max), and each rung of the resize ladder.
15. from-frame - infer_action_from_frame on the fake env's 480x640 frame on
             the card: the in-graph lanczos3 resize (fp32, TF32 off) against
             the CPU's within FRAME_TOL, the step bit-equal to infer_action
             on the card's pixel values, K1 17 times.
16. eval-agent-async - phase 14's agent again with the async pipeline turned
             on (its dispatch index set back to 0): the same checks and the
             residual-fetch line; then one dispatch under
             torch.cuda.set_sync_debug_mode("warn"), which must find no
             synchronizing operation, its host time beside the fetch's wait.
17. eval-batched - BatchedEvalAgent, 4 envs in lockstep over 4 episodes; each
             row of every batched chunk against the batch-1 step on that
             row's inputs and noise within BATCHED_TOL; K1 17 times per step;
             then a round of 4 and a batch-1 step timed 10 times each.
18. eval-agent-w4a8 - bridge_pool64_w4a8_steps1.yaml through the agent as
             shipped (act_steps 1): K2 370 and K1 17 times per step, every
             chunk bit-equal to a direct infer_action, and the agent's
             quantization-failure warning must not fire; the control step
             timed 10 times.
19. eval-cli - scripts/eval_pi0_simpler_torch.py run as a user runs it
             (bridge_pool64_w4a8_steps1.yaml, blurr preset, 2 episodes) in a
             subprocess: exit 0, both summary lines in its run.log and no
             quantization-failure warning there. (Its launches happen in
             another process and cannot count; phase 18 is the one whose
             K2 launches count.)
20. small-agent - bridge_tiny widths (an 80-token prefix, so the prefill
             takes K1), fp32, 10 flow steps: the same weights in an agent on
             the CPU and one on the card, the same summary lines and every
             chunk within SMALL_TOL.
21. text-pi0 - Pi-0's text mode (infer_text_prefill, infer_text_decode_step)
             at the full bridge.yaml width, bf16, joint.config.use_flash_attn
             set, random weights drawn on the card: a 276-token prompt and 20
             tokens at batch 1 (timed 3 times: prefill and per-token decode
             medians, tokens/s, peak memory) and at batch 2 with a row
             right-padded by 10. Each prefill launches K1 exactly 18 times,
             each decode step never. The K1 route against the plain
             attention on the same weights: the prefill's last logits and the
             decode logits teacher-forced on the same tokens within
             TEXT_REL_TOL of the largest |logit| (greedy agreement printed,
             not gated: random weights tie). The padded row against that row
             alone, the decode teacher-forced on the batch's tokens: printed
             in bf16; in fp32 on the same weights (K1's fp32 kernel at 276
             and 266 rows) its logits within TEXT_FP32_TOL of the largest
             |logit| and its tokens equal.
22. text-paligemma - PaliGemma-3B at google/paligemma-3b-pt-224's widths,
             bf16 random weights drawn on the card, written as 2 safetensors
             shards under HF keys with a config.json (bytes and seconds
             logged) and loaded by load_hf_model into a fresh model: the same
             bits, the same tokens and, teacher-forced on them, the same
             prefill and decode logits bit for bit (random weights repeat one
             token, so the tokens alone say little); generate and
             generate_fused equal, generate_fused's device part
             (fused_tokens) finds no synchronizing operation under
             set_sync_debug_mode("warn") and its last step's logits are
             generate's teacher-forced ones, bit for bit; the
             prefill, per-token decode and generate_fused timed (medians,
             tokens/s, peak memory); GemmaForCausalLM on the same weights
             equal to PaliGemma's stack on the same embeddings, tokens and
             teacher-forced logits bit for bit. Plain
             attention without the clamp, as in JAX: no kernel launches.
23. small-text - a small Pi-0 text model (bridge_tiny widths, fp32, an
             80-token prompt so the prefill takes K1, a padded row) and a
             small PaliGemma, each on the card against the CPU: tokens equal,
             logits within SMALL_TOL.
24. kernel-openvla - K2 against its plain version at every shape of the
             OpenVLA family's w4a8 path, as (M, K, N_pad, G): OpenVLA-7B's
             q/k/v/o, gate/up, down (G 43 of 256 rows) and head at M 1 (a
             decode token), M 288 (the prefill) and M 6 (a Jacobi sweep),
             OFT's M 346 (a partial row block), MiniVLA's at M 1 and M 288
             (G 7 of 128 rows at K 896, G 19 at K 4864, the tied head); each
             within INT4_REL_TOL and the same bits on a second call, its
             grid and S logged, its graph_ms beside its bytes bound and a
             bf16 matmul of the dense weight. Phases 25-30 record every
             shape the w4a8 linears give K2; after them, served-int4-shapes
             holds any that this list missed the same way.
25. serve-openvla-7b - OpenVLAActionServer("random-7b") in bf16, random
             weights drawn on the card: 5 requests at 224x224 and one
             256x320 frame through ActionClient, each answer 7 finite
             actions in [-1, 1], no kernel of the port launched (the ViTs
             and LLaMA attend in plain PyTorch, as JAX does in XLA); the
             median request time, the resident bytes, one request's device
             time under torch.profiler.
26. serve-openvla-7b-w4a8 - the same server w4a8 (the LLM drawn quantized):
             K2 exactly 1,575 times a request (7 tokens x (32 x 7 + the
             head)); the first token's logits through K2 against the same
             prefill with every product on int4_matmul_reference, within
             INT4_REL_TOL of the largest |logit|; then decode "jacobi": K2
             225 x (1 + sweeps) a request (the sweeps logged), its tokens
             against AR's, any difference explained by the AR step's top-2
             margin (within JACOBI_REL_MARGIN of its largest |logit|), its
             logits at the fixed point against the AR steps' within
             JACOBI_LOGIT_REL_TOL up to the first difference; and one decode
             from a guess away from the fixed point: two sweeps or more,
             the same checks. The planted faults of JACOBI_FAULTS are read
             and logged (not checked: see phase 31).
27. serve-openvla-7b-w8a8 - the same server w8a8 (torch._int_mm), no K2.
28. serve-openvla-oft - OFT at 7B, w4a8, with proprio: [8, 7] chunks, K2
             224 times a request (one forward at M 346, no head); a chunk
             through K2 against the plain route within INT4_REL_TOL.
29. serve-minivla - random-minivla in bf16 (no K2) and w4a8 (its tied head
             quantized: K2 1,183 times a request; the first token's logits
             through K2 against the plain route).
30. openvla-snapshot - OpenVLA-7B's widths at 2 LLaMA layers and 2 + 2 ViT
             blocks, bf16, written as an HF-keyed snapshot with
             blurr_spec.json and dataset_statistics.json, loaded by
             build_openvla from the directory: the same bits, and its
             answers under unnorm_key bridge_orig bit-equal to the model's
             built in memory.
30b. serve-batched-openvla - OpenVLA-7B w4a8 AR with max_batch 4 and 4
             instructions of 4 token counts: a bucket of the 4 gives each
             its solo tokens, a Jacobi bucket AR's; the 4 served one after
             another, then from 4 concurrent clients (chunks/s of each),
             every answer its solo one; K2 1,575 times a batch; its K2
             shapes held as served-int4-shapes holds them.
31. jacobi-fp32 - OpenVLA-7B at full width and depth in fp32, unquantized:
             Jacobi's logits at the fixed point against the AR steps'
             within JACOBI_FP32_REL_TOL (bf16 at w4a8 cannot tell planted
             faults from rounding), three frames, cold and from a guess
             away (two sweeps or more); each planted fault of
             JACOBI_FAULTS (tail positions shifted, the tail's mask wrong)
             must read over that bound.
32. eval-hf-7b-w4a8 - scripts/eval_hf_vla_simpler_torch.py's main()
             in-process: --model-id random-7b --quantization w4a8 --preset
             blurr, 1 episode of 4 steps on the fake env, whose make_env
             records every action: K2 exactly 1,575 times a control step;
             every env action bridge_action_to_simpler(predict_action)
             recomputed on the same processed inputs; summary.json with the
             JAX script's keys; the step's host-clock median and one step
             under torch.profiler (device time, K2's share); then the same
             command in a subprocess (exit 0, "Success rate:" in run.log).
33. eval-hf-snapshot - a full-depth OpenVLA-7B bf16 snapshot written by
             save_openvla_snapshot with a config.json norm_stats
             (bridge_orig) and a dataset_statistics.json (bridge_dataset):
             verify-checkpoint --kind openvla on it; the CLI on it with
             --quantization w4a8: quantize_llama_streaming's peak above its
             start within quantizing the head alone plus
             STREAMING_PEAK_SLACK (both logged), its bytes those of the
             drawn weights quantized layer by layer (that order's peak
             logged beside it), then the head, unnorm key
             bridge_orig, the actions as in phase 32; then an OFT head
             (chunk 8) and an 8-input proprio projector written beside it:
             OFT with proprio, K2 224 times a step, every action of each
             [8, 7] chunk executed.
34. eval-prismatic - scripts/eval_prismatic_vla_simpler_torch.py's main()
             at MiniVLA's widths and depth, bf16: --checkpoint random, then
             a prismatic .pt of weights drawn on the card in the
             run_dir/checkpoints/ layout beside a dataset_statistics.json:
             loaded bit-equal, no "PARTIAL LOAD", the dataset's unnorm key,
             the actions as in phase 32, every gripper value in {-1, 1}; no
             kernel launches (plain PyTorch in bf16).
35. verify-checkpoint - scripts/verify_checkpoint_torch.py's main() inside
             serve-checkpoint (the 12.95 GB .pt, --kind pi0), text-paligemma
             (its 2 shards, --kind paligemma) and eval-hf-snapshot (--kind
             openvla): each a clean match, exit 0.
Phases 32-34 run inside the recording of phases 25-30b, so
served-int4-shapes holds their K2 shapes too.
36. small-train - one QLoRA w4a8 training step (bridge_tiny, fp32, scope
             all, rank 4, the adapters' B drawn non-zero) on the card
             against the same step on the CPU: the same weights, batch,
             noise and t; the loss and every adapter gradient within
             SMALL_TRAIN_TOL of its largest |grad|; K2 launched on the card.
37. train-qlora-w4a8 - scripts/train_pi0_flow_torch.py's main() in-process
             at bridge.yaml's full width, random weights drawn on the card:
             --lora-rank 16 --lora-quantize-base w4a8 --dtype bf16
             --train-scope all, batch 2, 6 steps, from a sharded dataset of
             raw 480x640 frames the phase writes (the transform resizes
             them). K2 exactly 370 times a step (740 for one forward and
             backward with remat); the first step's loss and adapter
             gradients through K2 against the same step with every w4a8
             product on int4_matmul_reference, within INT4_REL_TOL; every
             K2 shape of the run held against the plain version
             (train-int4-shapes, with its bound and a bf16 matmul of the
             dense weight); the int4 payloads and scales bit-unchanged,
             every lora_b with a gradient path non-zero, every loss finite;
             the step median, the peak memory, one step's device time and
             K2's share.
38. train-resume - the same run with --save-every 2 --stop-after 3 into a
             manager root, then --resume-state from it to step 6: the
             parameters and buffers equal to phase 37's within
             TRAIN_RESUME_TOL (0: bit-equal).
39. train-serve - phase 37's --save-dir (the QLoRA tree, adapters unmerged)
             served by ActionServer (bridge.yaml, blurr preset): 3 requests,
             K2 370 times each, answers finite and in range, and the served
             model's chunk equal to the trained model's in memory on the
             same inputs and noise.
40. train-full - --train-scope action_expert --dtype fp32 at full width, 3
             steps (no kernel of the port runs), its peak memory; then a
             bf16 LoRA run whose --save-dir is merged, exported by
             scripts/export_torch_checkpoint_torch.py to a reference .pt and
             loaded by load_checkpoint bit-equal to the directory, which
             equals the trained model merged in memory.
41. train-openvla-qlora-w4a8 - scripts/train_openvla_lora_torch.py's main()
             in-process at OpenVLA-7B's widths: random-7b drawn quantized
             w4a8 on the card (no bf16 7B), rank-32 adapters on all seven
             projections, bf16, batch 2, the AR objective, 6 steps from a
             sharded dataset of 16 synthetic 224x224 examples the phase
             writes (write_openvla_dataset), --save-params. K2 exactly 225
             times a step (32 x 7 layer products at M 590, the head at the
             14 label rows; 449 for one forward and backward with remat);
             the first step's loss and factor gradients through K2 against
             every w4a8 product on int4_matmul_reference within
             INT4_REL_TOL; the int4 payloads and scales bit-unchanged, all
             224 lora_b non-zero, every loss finite; the step median, the
             peak memory, one step's device time and K2's share.
42. train-openvla-resume - the same run with --save-state --stop-after 3,
             then --resume-state to step 6: bit-equal to phase 41's.
43. train-openvla-serve - phase 41's --save-params served by the OpenVLA
             server (checkpoint_path, no quantization): the adapters over
             the int4 bases, 4 requests, 1,575 K2 launches each, every
             answer equal to the trained model's own; then hot-reloaded
             into the running server and answered the same.
44. train-openvla-oft - --oft --use-proprio at 7B w4a8, 3 steps, K2 224 a
             step; the head and projector .pt files of --save-adapter read
             back by load_oft_aux_params bit-equal. Then every K2 shape of
             phases 41-44 held bit-equal against the plain version, the
             same bits twice, timed in a CUDA graph beside its bound and a
             bf16 matmul of the dense weight (train-openvla-int4-shapes).
45. peft-roundtrip - a bf16 LoRA run on a shallow snapshot (2 LLM layers at
             7B widths) writes --save-adapter into its lora_adapter/;
             build_openvla(dir) merges it: the first token's logits within
             PEFT_LOGIT_REL_TOL of the trained model merged in memory; a
             snapshot whose base already holds the delta loads with
             "already contain" logged and its weights unchanged.
46. eval-openloop-vla - scripts/eval_openloop_vla_torch.py in a subprocess
             on phase 41's --save-params over the dataset's 16 examples:
             exit 0 and JAX's metric keys.
47. record  - phases 14 and 16 run with --record-dataset (serial, then
             async into another directory): one example per fetched
             chunk, the keys at their shapes (_check_recorded).
48. record-then-score - scripts/eval_openloop_torch.py in-process on each
             recorded directory (no transform, bridge.yaml bf16, K1 on):
             every recorded step an example, 17 K1 launches a batch.
49. openloop - the open-loop CLI in-process at batch 8 on synthetic data
             at full width: bridge.yaml bf16 (20 examples, the tail batch
             padded), pool64 w4a8 (K2 370 a batch) and bridge.yaml fp32;
             the metrics' keys, finite values, 17 K1 launches a batch.
50. gptq    - bridge_pool64_w4a8_steps1.yaml calibrated on 6 fake-env
             control steps of the fp model, both mixtures' 18 layers GPTQ
             w4a8 (wall time split into calibration and walk, calibration
             rows and peak memory printed); both calibration passes (the
             held-out one and GPTQ's own) launch K1 18 times a naive
             forward and nothing else; on held-out captures (episode 101)
             at layers 0, 8 and 17 of each mixture, each layer's output
             error summed over its 7 linears below the data-free
             rounding's (each linear logged); JAX's one-layer-at-a-time
             walk timed on layer 0 of each mixture; one served step: K2
             370 launches, the same bits twice.
51. closed-loop - blurr_tpu_torch.experiments.quant_closed_loop over
             pool64_bf16, pool64_w4a8 and pool64_w4a8_gptq (in-process),
             one episode each (its EPISODES is 2), its report
             lines.
52. openloop-flash - every (shape, dtype) phases 48-51 gave K1 (the
             calibration's [1,8,101,256] bf16 naive forward among them),
             with the first mask it met there, held against the plain
             version and timed beside SDPA and its bound.
53. openloop-int4-shapes - every K2 shape phases 48-51 gave held bit-equal
             against the plain version, the same bits twice, timed in a
             CUDA graph beside its bound and a bf16 matmul of the dense
             weight.
Tensor and data parallelism (M14's serving half): two ranks, one process
each, sharing the card over gloo (NCCL refuses two ranks on one device);
their times are two processes time-sharing one card. Phase 54 runs after
phase 3; phases 55-59 run after phase 53 in one child process (each joins
and leaves a process group there; this process never joins one), beside
phases 62-65, then 60-61 here.
54. tp2-kernels - K1 bf16 at a tp=2 rank's [1,4,277,256] and [1,4,97,256]
             (its 4 query heads over the one KV head) against its plain
             version; K2 at every tp=2 rank's column blocks of the pool64
             w4a8 and OpenVLA-7B w4a8 products, each rank bit-equal to its
             plain version and to the matching columns of the unsharded
             K2 output; K2 at the products tp=2 keeps whole (Pi-0's k and
             v) on the packing shard_params re-lays for the model axis,
             bit-equal to its plain version and to the one-rank packing's
             output; K3 at the pool64 int8 step's K/2 and N/2 shapes; each
             timed in a CUDA graph beside its bound.
55. serve-tp2 - bridge.yaml blurr bf16 (K1 on) on ActionServer(tp=2),
             drawn from phase 4's seed: 3 requests through the client, the
             answers within MODEL_TOL of phase 4's, K1 17 a step on each
             rank (server.rank_launches), rank 0's resident weight bytes
             against phase 4's, and rank 0's kernels in one step under the
             profiler.
56. serve-dp2 - the same config on ActionServer(dp=2, max_batch=4), 8
             requests from DP2_CLIENTS concurrent clients, K1 17 a batch on
             each rank; a bucket of 4 through both ranks against rank 0
             computing it alone, within MODEL_TOL.
57. serve-tp2-w4a8 / serve-tp2-int8 - pool64 w4a8 (K2 370 a step on each
             rank) and pool64 int8 (cache_fp_weight false, K3 380), as
             phase 55, against phases 7 and 9.
58. serve-tp2-openvla - OpenVLA-7B w4a8 AR on two tensor-parallel ranks:
             the same answers (tokens) as phase 26 on TP2_OPENVLA_FRAMES
             frames, K2 1,575 a request on each rank, then a hot reload
             (drawn again and re-sharded on every rank) and the same
             answer.
59. openloop-dp2 - scripts/eval_openloop_torch.py --dp 2 in-process on
             bridge.yaml bf16 with K1 on (a YAML over bridge.yaml, so the
             spawned rank reads it too) against --dp 1, within
             OPENLOOP_DP_RTOL; each rank's K1 17 a batch (the spawned
             rank's counts come back with its reply).
60. ranks-shapes - every shape rank 0 gave K1, K2 and K3 in phases 55-59
             (recorded as they ran) held against its plain version: K1 at
             each with the first mask it met there, K2 (bit-equal) and K3
             at those phase 54 did not hold.
61. profile-after-ranks - no process group and no child process left
             after phases 55-68 (the threads logged); then how many of 20
             K6 launches torch.profiler sees, logged only (PERF.md §7: it
             saw none here after the parallel phases, also since they run
             in children and this process joins no process group).
Training over ranks (M14's training half, part 1): each phase runs the
trainer's own main(argv) in child processes, rank 0 included, which
return every rank's losses, kernel launches in the steps, parameter,
buffer and moment bytes and peak memory, and the K2 shapes of the ranks
they ran. Losses against the one-card run of the same argv within
PARALLEL_TRAIN_RTOL; every rank logs the mean over the data ranks.
62. train-dp2-qlora-w4a8 - TRAIN_ARGS with --dp 2 --stop-after 3 on phase
             37's data (written again from its seed) through --multihost:
             two children with a launcher's variables (env://), at once
             with 63 (and phases 55-59 beside 62-65); each rank K2 370 a
             step on its row; against phase 37's first 3 losses.
63. train-tp2-qlora-w4a8 - the same with --tp 2 (rank 0 spawns rank 1):
             K2 370 a step on each rank's blocks; rank 0's resident bytes
             against phase 37's (TP2_TRAIN_BYTES_MAX).
64. train-fsdp-dp2 - bridge.yaml, action_expert, master-fp32, 2 steps, on
             one card and at --dp 2 --fsdp at once: each FSDP rank's
             parameter and moment bytes against one card's
             (FSDP_BYTES_MAX), the losses against one card's.
65. train-tp2-openvla-w8a8 - random-7b QLoRA w8a8, 2 steps, at --tp 2
             against tp=1 of the same argv, at once.
Training over ranks, part 2 (pipeline and sequence parallelism, ring
attention), in children as 62-65:
66. train-pp2-qlora-w4a8 - TRAIN_ARGS with --pp 2 --stop-after 3 (rank 0
             spawns stage 1; GPipe, 2 microbatches of one row): both
             stages' losses equal and against phase 37's first 3; K2 378 a
             step on stage 0 and 362 on stage 1 (PP2_K2_PER_STEP); each
             stage's resident bytes against phase 37's; its --save-dir
             (the gathered one-card tree) served on one card in the same
             child: the adapters over the int4 bases, one request, K2 370.
67. train-sp2-qlora-w4a8 - the same with --sp 2: K2 370 a step on each
             rank, each rank's SigLIP and vlm layers logged at 128 of the
             256 patches and 138 of the 276 tokens (the model's hooks).
68. ring-attention-2 - two children, ranks of a gloo group on cuda:0:
             ring_attention at [1,8,8192,256] over [1,1,8192,256] fp32,
             clamp 50, causal, then with the last 512 keys masked; the
             output and the gradients of sum(sin(out)) against
             grouped_attention on rank 0 (one query head at a time) within
             RING_OUT_TOL and RING_GRAD_RTOL / RING_GRAD_ATOL; a call's
             time, its gloo exchanges' and the plain version's logged. 68
             runs beside 65, 66 and 67 after it.
    train-ranks-int4-shapes - every K2 shape the ranks of 62-63 and rank 0
             of 66-67 gave, held bit-equal against the plain version,
             timed in a CUDA graph beside its bound and a bf16 matmul of
             the dense weight.
Then one JSON line of the kernels (launches summed over the served runs of
phases 4-10 with the batched, backpressure and reload runs, the
experiments run, the eval runs of phases 14-18 and 20, the text runs of
phases 21-23, the OpenVLA runs of phases 25-30b, the eval CLIs' runs of
phases 32-34, the training steps and served requests of phases 37-45 and
the CLI, calibration, GPTQ and experiment runs of phases 48-51,
every rank's runs of phases 55-59 and every rank's training steps of
phases 62-67, the counts set to 0 just before each; K1's, K2's and K3's
entries add their tp=2 shapes under "shapes_tp2", K2's the shapes of the
ranks of 62-63 and 66-67 under "shapes_train_ranks"; errors
and times measured here: ms and plain_ms with CUDA events, graph_ms and
plain_graph_ms in a CUDA graph, library_ms of one PyTorch call of the same
function where there is one, at the first timed shape of each kernel;
bound_ms, the larger of the bytes each input read once and the output
written once over 3.35 TB/s and the operations over the card's peak for
their type, computed from those inputs), and last the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

It imports nothing of JAX nor of the JAX package, and builds everything
from the checkout. It runs itself again under PYTHONHASHSEED=0 first: the
stub tokenizers hash words with Python's salted hash, and the parallel
phases' child processes must tokenize as this process did.
"""

from __future__ import annotations

import copy
import itertools
import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))
# the port and this script must not touch JAX: make any import of it fail
sys.modules["jax"] = None
for _var in ("BLURR_PLATFORM", "BLURR_COMPILE_CACHE"):
    os.environ.pop(_var, None)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from blurr_tpu_torch.experiments.timing import bound as _bound  # noqa: E402
from blurr_tpu_torch.experiments.timing import card  # noqa: E402
from blurr_tpu_torch.experiments.timing import events_ms as _time_ms  # noqa: E402
from blurr_tpu_torch.experiments.timing import graph_ms as _graph_ms  # noqa: E402

FP32_TOL = 2e-4  # fp32 sums in another order (TF32 off)
# K1's fp32 kernel against its plain version (TF32 off) at every kernel
# shape, q and k x0.3 and x1.0: its 3xTF32 products keep about 21 bits of
# each product, so it stays within a few fp32 roundings of the plain
# version (H100: 3.4e-7 / 2.9e-6 at the naive step); one TF32 product (a
# kernel that dropped the residuals) reads 8e-5 / 6e-4 there
# (scripts/ablate_flash_fp32_torch.py), past this bound, which FP32_TOL
# would not see
FP32_EXACT_TOL = 1e-5
FP32_QK_SCALES = (0.3, 1.0)
BF16_TOL = 2e-2  # bf16 output rounding against the fp32 plain version
# kernel vs plain attention through the whole bf16 control step: both round
# P to bf16 for P@V, but the kernel rounds the unnormalized p (and divides by
# l after, in fp32) where the plain path rounds the normalized weights, and
# the sums run in another order, in each of 17 layers of a random-weight
# model; 5e-2 is ~13 bf16 ulps at 1.0
MODEL_TOL = 5e-2
# fp32 on the card (kernel, cuBLAS with TF32 off) against fp32 on the CPU:
# the same formulas summed in another order through 10 flow steps
SMALL_TOL = 1e-4
# the same, quantized: the int8 activations round alike on both sides, but
# an fp32 input within rounding of a half step may round the other way on
# one of them, which moves that activation by one step (1/127 of its row)
SMALL_W4A8_TOL = 1e-3
# the same with the int8 weight-only tier and the int8 KV cache. The card's
# fp32 prefix K/V and activations differ from the CPU's by fp32 noise, so a
# few values round the other way: a cached K/V value to the other int8 step
# (clip/127), a kernel input to the other bf16. Each such flip cascades
# through the flow steps (H100: 2 of 31,104 cached values flipped and the
# actions moved by 4.0e-4; with the KV cache fp, bf16 flips alone moved them
# by 3.4e-4). The phase's second witness gives the card the CPU's rounding
# wherever the two differ and holds that run to SMALL_TOL; a kernel that
# skips the bf16 rounding of its input stays 1.4e-3 away there
SMALL_INT8_TOL = 1e-3
# the fp32 naive step against the fp32 cached step on the card (TF32 off):
# the same function, the prefix K/V computed in every flow step and the
# action rows attended through the kernel over 281 keys instead of the
# plain decode attention, summed in another order through 10 flow steps
BASELINE_TOL = 1e-3
# the int4 kernel against its plain version: both sum exact int32 group dots
# times the scale in fp32, in group order, without FMA; any difference is a
# finding (PERF.md), bounded by 1e-6 of the largest output
INT4_REL_TOL = 1e-6
# dynamic batching (serve-batched, serve-backpressure, serve-batched-w4a8,
# serve-batched-openvla): the batcher waits this long after a bucket's first
# request for more; each concurrency runs BATCHED_REQUESTS per client
SERVE_MAX_BATCH = 8
BATCH_WINDOW_MS = 10.0
CONCURRENCY = (1, 2, 4, 8)
BATCHED_REQUESTS = 8
BACKPRESSURE_REQUESTS = 4
BATCHED_K1_SHAPES = [(2, 8, 1, 277, 277, 256), (8, 8, 1, 277, 277, 256)]
MAX_W4A8_WEIGHT_BYTES = 3.0e9
N_REQUESTS = 3
# control steps timed after each eval-agent run, and the model steps a served
# phase's median takes (cut from 20 and 10, then from 10 and 5, to keep the
# whole script inside its time limit with the parallel phases)
AGENT_TIMED_STEPS = 5
STEP_MEDIAN_STEPS = 3
PI0_SHAPE = (1, 8, 1, 277, 277, 256)  # b, nh, kvh, sq, skv, d
NAIVE_SHAPE = (1, 8, 1, 281, 281, 256)  # the naive step: 276 + proprio + 4 actions
POOL64_SHAPE = (1, 8, 1, 97, 97, 256)
BASELINE_BUCKET_SHAPE = (4, 8, 1, 281, 281, 256)  # a batched baseline server's naive step
BATCHED_SHAPE = (4, 8, 1, 277, 277, 256)  # the batched eval's prefill, 4 envs
KERNEL_SHAPES = [
    PI0_SHAPE,                  # the joint prefill, pad rows fully masked
    BATCHED_SHAPE,              # the same over 4 rows, each its own prompt length
    NAIVE_SHAPE,                # the naive step's joint attention, full block mask
    POOL64_SHAPE,               # the pool64 prefill (96 + proprio)
    (2, 4, 2, 100, 150, 64),   # ragged GQA
    (1, 4, 1, 64, 64, 32),     # smallest head_dim
]
# (M, K, N, G) of every w4a8 linear of the pool64 step: vlm q/o, k/v, gate/up,
# down at the 96-token prefill; action (and proprio) q, k/v, o, gate/up, down
# at M 1 (proprio prefill) and 4 (decode)
INT4_SHAPES = [
    (96, 2048, 2048, 4), (96, 2048, 256, 4), (96, 2048, 16384, 4),
    (96, 16384, 2048, 32),
    (1, 1024, 2048, 2), (4, 1024, 2048, 2), (1, 1024, 256, 2), (4, 1024, 256, 2),
    (1, 2048, 1024, 4), (4, 2048, 1024, 4), (1, 1024, 4096, 2), (4, 1024, 4096, 2),
    (1, 4096, 1024, 8), (4, 4096, 1024, 8),
]
# vlm gate (first: the kernels line's entry), vlm down projection, action gate
INT4_TIMED = [(96, 2048, 16384, 4), (96, 16384, 2048, 32), (4, 1024, 4096, 2)]
# (M, K, N) of every int8 linear of the pool64 int8 step: action (and
# proprio) q, k/v, o, gate/up, down at M 1 (proprio prefill) and 4 (decode);
# the action encoder's w1, w2, w3 at M 4
INT8_SHAPES = [
    (1, 1024, 2048), (4, 1024, 2048), (1, 1024, 256), (4, 1024, 256),
    (1, 2048, 1024), (4, 2048, 1024), (1, 1024, 4096), (4, 1024, 4096),
    (1, 4096, 1024), (4, 4096, 1024),
    (4, 7, 1024), (4, 2048, 1024), (4, 1024, 1024),
]
# the action mixture's int8 linears at the decode of buckets of 2, 4 and 8
# (M = 4 x bucket): a batched int8 server's shapes
INT8_BATCHED_SHAPES = [(m, k, n) for m in (8, 16, 32) for k, n in (
    (1024, 2048), (1024, 256), (2048, 1024), (1024, 4096), (4096, 1024))]
INT8_TIMED = [(4, 1024, 4096), (4, 4096, 1024)]  # action gate, action down
# the int8 kernel's fp32 sum against the plain version's float64 one
INT8_FP32_REL_TOL = 1e-5
BF16_ROUNDING = 2.0**-8  # one bf16 rounding, relative (8 significant bits)
INT8_STEP_LAUNCHES = 380  # 17 x 7 + 3 proprio prefill, 2 x (18 x 7 + 3) decode
W4A8_STEP_LAUNCHES = 370  # 2 x (17 x 7 + 3) prefill (vlm, proprio), 18 x 7 decode
KERNEL_NAMES = ("flash_attention", "int4_matmul", "int8_matmul", "w8a8_matmul",
                "int4_split_matmul", "fused_ffn")
# Pi-0's text prefill (bridge.yaml): 276 prompt rows over a cache of 296
# keys (20 new tokens), the last 20 keys masked; and 2 rows, the second
# right-padded by TEXT_PAD
TEXT_NEW_TOKENS = 20
TEXT_PAD = 10
TEXT_SHAPE = (1, 8, 1, 276, 276 + TEXT_NEW_TOKENS, 256)
TEXT_PADDED_SHAPE = (2, 8, 1, 276, 276 + TEXT_NEW_TOKENS, 256)
# q and k at this scale (per element, d = 256) give logits of std ~9, the
# largest past 20 (the clamp takes 45 to 36): where clamp 50 and off differ
TEXT_LARGE_QK = 3.0
# the bf16 text path through K1 against the plain attention on the same
# weights (the prefill's last logits, the decode logits teacher-forced on
# the same tokens), as a share of the largest |logit|: both round at the
# same places, the kernel's P and its sums in another order, through 18
# layers. On an H100 the sound path reads 0.76%; K1 given the cache's 20
# masked keys unmasked (a planted fault) reads 6.9% on the prefill and 4.8%
# teacher-forced. 2e-2 sits between them.
TEXT_REL_TOL = 2e-2
# fp32 (TF32 off), the padded row of a batch against that row alone, as a
# share of the largest |logit|: the same sums, but matmuls of another M may
# take another order. On an H100 it reads 6.3e-7; decode steps that let
# the pad slots through (a planted fault) read 1.9e-2.
TEXT_FP32_TOL = 1e-4
# google/paligemma-3b-pt-224's config.json: its widths, as
# blurr_tpu/config/eval/paligemma_arch.yaml gives them
PALIGEMMA_3B = {
    "model_type": "paligemma", "image_token_index": 257152, "pad_token_id": 0,
    "projection_dim": 2048, "hidden_size": 2048, "vocab_size": 257216,
    "text_config": {"model_type": "gemma", "vocab_size": 257216, "hidden_size": 2048,
                    "intermediate_size": 16384, "num_hidden_layers": 18,
                    "num_attention_heads": 8, "num_key_value_heads": 1, "head_dim": 256,
                    "num_image_tokens": 256},
    "vision_config": {"model_type": "siglip_vision_model", "hidden_size": 1152,
                      "intermediate_size": 4304, "num_hidden_layers": 27,
                      "num_attention_heads": 16, "image_size": 224, "patch_size": 14,
                      "projection_dim": 2048},
}
# the small text models card against CPU (fp32, TF32 off)
SMALL_PALIGEMMA = {
    "vision_config": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
                      "num_attention_heads": 4, "image_size": 56, "patch_size": 14},
    "text_config": {"vocab_size": 1000, "hidden_size": 128, "intermediate_size": 512,
                    "num_hidden_layers": 2, "num_attention_heads": 8,
                    "num_key_value_heads": 1, "head_dim": 32},
    "image_token_index": 999, "pad_token_id": 0, "projection_dim": 128, "hidden_size": 128,
}


# the one-process servers' answers (and resident weight bytes) by phase,
# which the tensor- and data-parallel phases are held against
ONE_RANK = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def probe() -> str:
    smi = card()
    from blurr_tpu_torch.ops.kernels import find_nvcc

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"card: {smi}")
    log(f"probe: device={name} capability={cap} torch={torch.__version__} "
        f"cuda={torch.version.cuda} nvcc={find_nvcc()} "
        f"count={torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability 9.0), got {cap}")
    return name


def build() -> None:
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from blurr_tpu_torch.ops import kernels

    def one(name):
        t0 = time.monotonic()
        path = kernels.build(name)
        return path, time.monotonic() - t0

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(KERNEL_NAMES)) as pool:
        built = dict(zip(KERNEL_NAMES, pool.map(one, KERNEL_NAMES)))
    log(f"build: {len(KERNEL_NAMES)} kernels in {time.monotonic() - t0:.2f} s")
    for name, (path, secs) in built.items():
        kernels.load(name)
        log(f"build: {name} in {secs:.2f} s -> {path.relative_to(REPO_ROOT)}")
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name} ptxas {line.strip()}")


def _attention_inputs(shape, device, qk_scale=0.3, mask=None):
    """q, k and v drawn at ``shape``; the mask is ``mask`` where one is given
    (one a path passed to K1), else one like a Pi-0 prefill's or naive step's
    at their shapes, else random."""
    b, nh, kvh, sq, skv, d = shape
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(b, nh, sq, d, generator=g, device=device) * qk_scale
    k = torch.randn(b, kvh, skv, d, generator=g, device=device) * qk_scale
    v = torch.randn(b, kvh, skv, d, generator=g, device=device)
    if mask is None and nh == 8 and kvh == 1 and sq == skv:  # a Pi-0 prefill or naive step
        from blurr_tpu_torch.ops.masks import pi0_full_mask, pi0_prefix_mask

        # the image tokens and a short prompt valid, 10 pad rows fully masked
        # (3 more in each further batch row, so every row has its own mask)
        n_text = 276 if sq == NAIVE_SHAPE[3] else sq - 1
        am = torch.zeros(b, n_text, dtype=torch.int32, device=device)
        for i in range(b):
            am[i, :n_text - 10 - 3 * i] = 1
        mask = (pi0_full_mask(am, n_text, 1, 4) if sq == NAIVE_SHAPE[3]
                else pi0_prefix_mask(am, n_text, 1))
    elif mask is None:
        mask = torch.rand(b, sq, skv, generator=g, device=device) > 0.3
        mask[:, :, 0] = True
    return q, k, v, mask


def _kernel_times(kernel, plain, library=None) -> dict:
    """The times of the kernels line, taken the same way for every kernel:
    ``ms`` and ``plain_ms`` with CUDA events around 50 eager launches (the
    kernel's the lesser of two runs), ``graph_ms`` and ``plain_graph_ms``
    inside a CUDA graph (the device's time alone); ``library_ms`` (events)
    and ``library_graph_ms`` of one PyTorch call of the same function, or
    None where there is none."""
    return {"ms": min(_time_ms(kernel), _time_ms(kernel)), "plain_ms": _time_ms(plain),
            "graph_ms": min(_graph_ms(kernel), _graph_ms(kernel)),
            "plain_graph_ms": _graph_ms(plain),
            "library_ms": None if library is None else _time_ms(library),
            "library_graph_ms": None if library is None else _graph_ms(library)}


def _fmt_times(t: dict, dense=None, dense_name: str = "") -> str:
    """The times of ``_kernel_times``; with ``dense``, a bf16 matmul of the
    dequantized weight timed both ways (context, not in the kernels line)."""
    line = (f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms (CUDA events, 50 "
            f"launches each); in a CUDA graph kernel {t['graph_ms']:.4f} ms, plain "
            f"{t['plain_graph_ms']:.4f} ms")
    if t["library_ms"] is not None:
        line += (f"; library call {t['library_ms']:.4f} ms (events), "
                 f"{t['library_graph_ms']:.4f} ms (graph)")
    if dense is not None:
        line += (f"; bf16 matmul of {dense_name} {_time_ms(dense):.4f} ms (events), "
                 f"{_graph_ms(dense):.4f} ms (graph)")
    return line


def _hold_flash(shape, dtype, tol, label, device, qk_scale=0.3, mask=None) -> float:
    """K1 at ``shape`` (b, nh, kvh, sq, skv, d) in ``dtype``, q and k drawn
    at ``qk_scale`` (the mask ``_attention_inputs`` gives), against its plain
    version in fp32, within ``tol``, and the same bits on a second call; its
    launch geometry logged. Returns the largest error."""
    from blurr_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
        grid,
    )

    q, k, v, mask = _attention_inputs(shape, device, qk_scale, mask)
    qc, kc, vc = q.to(dtype), k.to(dtype), v.to(dtype)
    out = flash_attention(qc, kc, vc, mask)
    again = torch.equal(out, flash_attention(qc, kc, vc, mask))
    ref = flash_attention_reference(qc.float(), kc.float(), vc.float(), mask)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"kernel output not finite at {shape} {dtype}")
    err = (out.float() - ref).abs().max().item()
    blocks, part_keys = grid(*shape, dtype)
    log(f"{label}: flash_attention {shape} {str(dtype)[6:]} q and k x{qk_scale:g} "
        f"max_abs_err={err:.3e} (tol {tol:g}), same bits on a second call {again}; "
        f"grid {blocks} (64-row tiles of the folded heads, {blocks[1]} key parts of "
        f"{part_keys} keys, batch x KV heads)")
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
    if not again:
        raise RuntimeError(f"kernel gives other bits on a second call at {shape} {dtype}")
    return err


def kernel_vs_plain(device) -> dict:
    """Flash attention against its plain version, each the same bits on a
    second call (its launch geometry logged): bf16 within BF16_TOL at every
    kernel shape; fp32 within FP32_EXACT_TOL at every kernel shape and a
    batched baseline server's [4,8,281,256], with q and k x0.3 and x1.0.
    Then timed beside the plain version, SDPA (the library's
    fused attention, without the soft clamp) and the bound: bf16 and fp32
    at the 277-row prefill, fp32 at the naive step's 281 rows and at a
    batched baseline bucket of 4 (against the 3xTF32 peak), bf16 at the
    pool64 prefill. Returns the kernels line's entry: bf16 at the Pi-0
    prefill."""
    from blurr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for shape in KERNEL_SHAPES:
        errs[(shape, torch.bfloat16)] = _hold_flash(shape, torch.bfloat16, BF16_TOL, "kernel",
                                                    device)
    for shape in KERNEL_SHAPES + [BASELINE_BUCKET_SHAPE]:
        for qk_scale in FP32_QK_SCALES:
            _hold_flash(shape, torch.float32, FP32_EXACT_TOL, "kernel-fp32", device, qk_scale)
    smi = card()
    times, bounds = {}, {}
    for shape, dtypes in ((PI0_SHAPE, (torch.bfloat16, torch.float32)),
                          (NAIVE_SHAPE, (torch.float32,)),
                          (BASELINE_BUCKET_SHAPE, (torch.float32,)),
                          (POOL64_SHAPE, (torch.bfloat16,))):
        q, k, v, mask = _attention_inputs(shape, device)
        b, nh, _, sq, skv, d = shape
        for dtype in dtypes:
            qc, kc, vc = q.to(dtype), k.to(dtype), v.to(dtype)
            t = times[(shape, dtype)] = _kernel_times(
                lambda: flash_attention(qc, kc, vc, mask),
                lambda: flash_attention_reference(qc, kc, vc, mask),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qc, kc, vc, attn_mask=mask[:, None], enable_gqa=True))
            log(f"kernel: time at {shape} {str(dtype)[6:]}: {_fmt_times(t)}")
            kind = "bf16" if dtype == torch.bfloat16 else "tf32x3"
            bounds[(shape, dtype)] = bound = _bound(
                (qc, kc, vc, mask), (qc,), 4 * b * nh * sq * skv * d, kind)
            log(f"kernel: flash_attention bound at {shape} {kind} {bound['bound_ms']:.5f} ms "
                f"({bound['bound_by']}{', TF32 peak over three products' if kind == 'tf32x3' else ''}); "
                f"in a CUDA graph {bound['bound_ms'] / t['graph_ms']:.1%} of it reached; "
                f"faster than SDPA {t['graph_ms'] < t['library_graph_ms']}, than the plain "
                f"version {t['graph_ms'] < t['plain_graph_ms']}; on {smi}")
    key = (PI0_SHAPE, torch.bfloat16)
    return {"max_abs_err": errs[key], **times[key], **bounds[key]}


def kernel_text_vs_plain(device) -> None:
    """K1 at Pi-0's text prefill: 276 query rows over a layer's slice of the
    stacked [L, B, KVH, 296, D] cache buffer, the 20 unwritten keys masked
    (random there, so a leak shows), at batch 1 and at batch 2 with the
    second row right-padded; fp32 and bf16, the soft clamp 50 and off, each
    against the plain version and the same bits on a second call (its grid
    logged). Each at two scales of q and k: small logits (|logit| < 1, as
    random weights give) and TEXT_LARGE_QK, whose largest |logit| is past
    20, where the clamp moves a logit by more than 1: there the kernel's
    two clamps must differ by more than the tolerance, so a kernel that
    ignored its clamp fails. Then timed at batch 1, bf16, both clamps,
    beside the plain version, its bound and, for the clamp off, SDPA (the
    same function)."""
    from blurr_tpu_torch.models.pi0.pizero import text_mask
    from blurr_tpu_torch.ops.attention import DEFAULT_SOFTCLAMP
    from blurr_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
        grid,
    )

    smi = card()
    inputs = {}
    for shape, qk_scale in itertools.product((TEXT_SHAPE, TEXT_PADDED_SHAPE),
                                             (0.3, TEXT_LARGE_QK)):
        b, nh, kvh, sq, skv, d = shape
        g = torch.Generator(device=device).manual_seed(4)
        q = torch.randn(b, nh, sq, d, generator=g, device=device) * qk_scale
        k_buf = torch.randn(2, b, kvh, skv, d, generator=g, device=device) * qk_scale
        v_buf = torch.randn(2, b, kvh, skv, d, generator=g, device=device)
        valid = torch.ones(b, sq, dtype=torch.bool, device=device)
        valid[1:, sq - TEXT_PAD:] = False
        mask = text_mask(valid, sq, skv)
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            qc, kc, vc = q.to(dtype), k_buf.to(dtype)[1], v_buf.to(dtype)[1]
            if qk_scale != TEXT_LARGE_QK:
                inputs[(shape, dtype)] = qc, kc, vc, mask
            logits = torch.einsum("bhqd,bsd->bhqs", qc.float(), kc[:, 0].float()) * d ** -0.5
            top = logits.masked_fill(~mask[:, None], 0).abs().max().item()
            blocks, part_keys = grid(*shape, dtype)
            outs = {}
            for clamp in (DEFAULT_SOFTCLAMP, None):
                out = flash_attention(qc, kc, vc, mask, softclamp=clamp)
                again = torch.equal(out, flash_attention(qc, kc, vc, mask, softclamp=clamp))
                ref = flash_attention_reference(qc.float(), kc.float(), vc.float(), mask, clamp)
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item()
                log(f"kernel-text: flash_attention {shape} {str(dtype)[6:]} softclamp {clamp}, "
                    f"q and k x{qk_scale:g} (largest |logit| {top:.2f}), K/V a layer's slice "
                    f"of the cache buffer, keys {sq}.. masked"
                    f"{f', row 1 padded by {TEXT_PAD}' if b > 1 else ''}: max_abs_err={err:.3e} "
                    f"(tol {tol:g}), same bits on a second call {again}; grid {blocks} "
                    f"({blocks[1]} key parts of {part_keys} keys)")
                if not torch.isfinite(out).all():
                    raise RuntimeError(f"kernel output not finite at {shape} {dtype}")
                torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
                if not again:
                    raise RuntimeError(f"kernel gives other bits on a second call at {shape}")
                outs[clamp] = out.float()
            apart = (outs[DEFAULT_SOFTCLAMP] - outs[None]).abs().max().item()
            log(f"kernel-text: clamp 50 against off at {shape} {str(dtype)[6:]} x{qk_scale:g}: "
                f"max_abs_diff={apart:.3e}")
            if qk_scale == TEXT_LARGE_QK and not (top > 20 and apart > 10 * tol):
                raise RuntimeError(f"kernel-text: the clamp does not show at {shape} {dtype}: "
                                   f"largest |logit| {top}, clamp 50 vs off {apart}")
    qc, kc, vc, mask = inputs[(TEXT_SHAPE, torch.bfloat16)]
    b, nh, _, sq, skv, d = TEXT_SHAPE
    # the work these inputs need: the 276 unmasked keys of every row
    least = _bound((qc, kc, vc, mask), (qc,), 4 * b * nh * sq * sq * d, "bf16")
    for clamp in (DEFAULT_SOFTCLAMP, None):
        sdpa = None if clamp else (lambda: torch.nn.functional.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=mask[:, None], enable_gqa=True))
        times = _kernel_times(lambda: flash_attention(qc, kc, vc, mask, softclamp=clamp),
                              lambda: flash_attention_reference(qc, kc, vc, mask, clamp), sdpa)
        log(f"kernel-text: time at {TEXT_SHAPE} bf16 softclamp {clamp}: {_fmt_times(times)}; "
            f"bound {least['bound_ms']:.5f} ms ({least['bound_by']}, 276 keys a row); "
            f"on {smi}")


def _int4_inputs(g: torch.Generator, m, k, n, groups, bn=None):
    """Random K2 inputs on the generator's device: int8 x [M, K], int4
    values [K, N_pad] packed block-major as pick_block_layout(N) gives (or
    at block width ``bn``, N then N_pad), and fp32 scales [G, N_pad] of the
    size the w4a8 quantizer gives Pi-0's weights. Returns (x, packed,
    scale, the int4 values as int8)."""
    from blurr_tpu_torch.ops.int4_matmul import pack_int4, pick_block_layout, to_block_major

    device = g.device
    bn, n_pad = pick_block_layout(n) if bn is None else (bn, n)
    q = torch.randint(-8, 8, (k, n_pad), dtype=torch.int8, device=device, generator=g)
    x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=device, generator=g)
    s = torch.rand(groups, n_pad, device=device, generator=g) * 2e-3 + 1e-4
    return x, to_block_major(pack_int4(q), bn), s, q


def int4_vs_plain(device) -> dict:
    """The int4 kernel against its plain version at every w4a8 shape of the
    step, the same bits on a second call (its split of K and grid logged),
    then timed beside the plain version and a bf16 matmul of the dense
    weight (the yardstick: whether int4 pays on this card)."""
    from blurr_tpu_torch.ops.int4_matmul import grid, int4_matmul, int4_matmul_reference

    g = torch.Generator(device=device).manual_seed(1)

    def inputs(m, k, n, groups):
        return _int4_inputs(g, m, k, n, groups)

    worst = 0.0
    bounds = {}
    for shape in INT4_SHAPES:
        x, packed, s, _ = inputs(*shape)
        out = int4_matmul(x, packed, s)
        again = torch.equal(out, int4_matmul(x, packed, s))
        ref = int4_matmul_reference(x, packed, s)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        bound = INT4_REL_TOL * ref.abs().max().item()
        ms = _time_ms(lambda: int4_matmul(x, packed, s), iters=20)
        graph_ms = _graph_ms(lambda: int4_matmul(x, packed, s))
        m, k, _, groups = shape
        blocks = grid(m, k, s.shape[1], groups)
        log(f"kernel: int4_matmul (M, K, N, G)={shape} max_abs_err={err:.3e} "
            f"bit-equal={torch.equal(out, ref)} (bound {bound:.3e}), same bits on a "
            f"second call {again}; S={blocks[1]} slices of K, grid {blocks}; kernel "
            f"{ms:.4f} ms (CUDA events, 20 launches), {graph_ms:.4f} ms in a CUDA graph")
        if not (torch.isfinite(out).all() and err <= bound and again):
            raise RuntimeError(f"int4 kernel disagrees with its plain version at {shape}")
        worst = max(worst, err)
    times = {}
    for shape in INT4_TIMED:
        x, packed, s, q = inputs(*shape)
        xb, wb = x.bfloat16(), q.bfloat16()
        times[shape] = _kernel_times(lambda: int4_matmul(x, packed, s),
                                     lambda: int4_matmul_reference(x, packed, s))
        m, k, n, _ = shape
        bounds[shape] = _bound((x, packed, s), (torch.empty(m, s.shape[1], device=device),),
                               2 * m * k * n, "int8")
        line = _fmt_times(times[shape], lambda: torch.matmul(xb, wb), "the dense weight")
        log(f"kernel: int4_matmul time at (M, K, N, G)={shape}: {line}; bound "
            f"{bounds[shape]['bound_ms']:.5f} ms ({bounds[shape]['bound_by']})")
    return {"max_abs_err": worst, **times[INT4_TIMED[0]], **bounds[INT4_TIMED[0]]}


def int8_vs_plain(device) -> dict:
    """The int8 kernel against its plain version at every int8 shape of the
    step, fp32 and bf16 x, each giving the same bits on a second call (its
    split of K and grid logged), then timed (bf16 x, the served dtype)
    beside the plain version, a bf16 matmul of the dequantized weight and
    the library's int8 weight-only product (``torch._weight_int8pack_mm``:
    bf16 scales, so close to the kernel's function but not equal), each
    both ways: launches timed with CUDA events, which at these shapes time
    the wrapper's host work, and inside a CUDA graph, which times the
    device. Returns the largest fp32 error (the kernel's own summation) and
    the times at the action gate."""
    from blurr_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference, slices

    g = torch.Generator(device=device).manual_seed(2)

    def inputs(m, k, n):
        x = torch.randn(m, k, device=device, generator=g) * 2
        q = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=device, generator=g)
        # scales of the size the int8 quantizer gives Pi-0's weights
        s = torch.rand(n, device=device, generator=g) * 2e-4 + 1e-5
        return x, q, s

    worst_fp32 = 0.0
    bounds = {}
    for shape in INT8_SHAPES + INT8_BATCHED_SHAPES:
        x, q, s = inputs(*shape)
        ref = int8_matmul_reference(x, q, s)  # fp32; rounds x to bf16 itself
        top = ref.abs().max().item()
        m, k, n = shape
        split = slices(m, k, n)
        for dtype in (torch.float32, torch.bfloat16):
            out = int8_matmul(x.to(dtype), q, s)
            again = torch.equal(out, int8_matmul(x.to(dtype), q, s))
            torch.cuda.synchronize()
            err = (out.float() - ref).abs()
            bound = INT8_FP32_REL_TOL * top
            if dtype == torch.bfloat16:
                bound = bound + BF16_ROUNDING * ref.abs()
            ok = bool(torch.isfinite(out).all()) and bool((err <= bound).all()) and again
            log(f"kernel: int8_matmul (M, K, N)={shape} {str(dtype)[6:]} "
                f"max_abs_err={err.max().item():.3e} (bound {INT8_FP32_REL_TOL * top:.3e}"
                f"{' + one bf16 rounding of each output' if dtype == torch.bfloat16 else ''}), "
                f"same bits on a second call {again}; S={split} slices of K, grid "
                f"{(-(-n // 64), split, -(-m // 16))}")
            if not ok:
                raise RuntimeError(f"int8 kernel disagrees with its plain version at {shape} {dtype}")
            if dtype == torch.float32:
                worst_fp32 = max(worst_fp32, err.max().item())
        xb = x.bfloat16()
        ms = _time_ms(lambda: int8_matmul(xb, q, s), iters=20)
        graph_ms = _graph_ms(lambda: int8_matmul(xb, q, s))
        least = _bound((xb, q, s), (xb.new_empty(m, n),), 2 * m * k * n, "bf16")
        q_nk, s_bf16, wb = q.t().contiguous(), s.bfloat16(), (q.float() * s).bfloat16()
        library = _graph_ms(lambda: torch._weight_int8pack_mm(xb, q_nk, s_bf16))
        dense = _graph_ms(lambda: torch.matmul(xb, wb))
        log(f"kernel: int8_matmul (M, K, N)={shape} bf16 kernel {ms:.4f} ms "
            f"(CUDA events, 20 launches), {graph_ms:.4f} ms in a CUDA graph; bound "
            f"{least['bound_ms']:.5f} ms ({least['bound_by']}); in a CUDA graph "
            f"torch._weight_int8pack_mm {library:.4f} ms, bf16 matmul of the dequantized "
            f"weight {dense:.4f} ms")
    times = {}
    for shape in INT8_TIMED:
        x, q, s = inputs(*shape)
        xb = x.bfloat16()
        wb = (q.float() * s).bfloat16()
        q_nk, s_bf16 = q.t().contiguous(), s.bfloat16()  # the library's layout: [N, K]
        times[shape] = _kernel_times(lambda: int8_matmul(xb, q, s),
                                     lambda: int8_matmul_reference(xb, q, s),
                                     lambda: torch._weight_int8pack_mm(xb, q_nk, s_bf16))
        m, k, n = shape
        bounds[shape] = _bound((xb, q, s), (xb.new_empty(m, n),), 2 * m * k * n, "bf16")
        line = _fmt_times(times[shape], lambda: torch.matmul(xb, wb), "the dequantized weight")
        log(f"kernel: int8_matmul time at (M, K, N)={shape} bf16: {line}; bound "
            f"{bounds[shape]['bound_ms']:.5f} ms ({bounds[shape]['bound_by']})")
    return {"max_abs_err": worst_fp32, **times[INT8_TIMED[0]], **bounds[INT8_TIMED[0]]}


def experiments_vs_plain(device) -> dict:
    """The kernels of the experiment harnesses against their plain versions
    at every harness shape, with scales that are not 1 so the rounding of
    the int32 dot and the multiply show: K4, K5 and K2 at one group bit for
    bit, K6 within one bf16 step at its largest output. Then each timed at
    its first shape (K4 at every harness shape beside torch._int_mm, K6
    beside the three bf16 matmuls). Returns each kernel's entry of the
    kernels line."""
    from blurr_tpu_torch.experiments import bench_fused_ffn, bench_lowbit_matmul, lowbit
    from blurr_tpu_torch.experiments.bench_lowbit_matmul import (
        ADJACENT_M,
        BLOCK_MAJOR,
        ROW_MAJOR_M,
        block_major_width,
    )
    from blurr_tpu_torch.ops import kernels
    from blurr_tpu_torch.ops.fused_ffn import fused_ffn, fused_ffn_reference
    from blurr_tpu_torch.ops.fused_ffn import _CLUSTERS as FFN_CLUSTERS
    from blurr_tpu_torch.ops.fused_ffn import card_clusters as ffn_clusters
    from blurr_tpu_torch.ops.fused_ffn import kernel_grid as ffn_grid
    from blurr_tpu_torch.ops.int4_matmul import int4_matmul_reference, pack_int4, to_block_major
    from blurr_tpu_torch.ops.int4_split_matmul import grid as split_grid
    from blurr_tpu_torch.ops.int4_split_matmul import (
        int4_split_matmul,
        int4_split_matmul_reference,
    )
    from blurr_tpu_torch.ops.quant import INT_MM_PAD_ROWS
    from blurr_tpu_torch.ops.w8a8_matmul import grid as w8a8_grid
    from blurr_tpu_torch.ops.w8a8_matmul import w8a8_matmul, w8a8_matmul_reference

    g = torch.Generator(device=device).manual_seed(3)
    k, n = bench_lowbit_matmul.K, bench_lowbit_matmul.NP

    def randint(shape, low=-127, high=128):
        return torch.randint(low, high, shape, dtype=torch.int8, device=device, generator=g)

    def scales(cols):
        return torch.rand(1, cols, device=device, generator=g) * 1e-2 + 1e-4

    def held(name, shape, out, ref) -> float:
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        log(f"kernel-experiments: {name} (M, K, N)={shape} max_abs_err={err:.3e} "
            f"bit-equal={torch.equal(out, ref)}")
        if not torch.equal(out, ref):
            raise RuntimeError(f"{name} disagrees with its plain version at {shape}")
        return err

    entries = {}
    # K4: the w8a8 product, row-major and block-major, each the same bits on
    # a second call, then timed at every harness shape (the kernels line's
    # entry: the first)
    w8a8_shapes = ([(m, k, n, None) for m in ROW_MAJOR_M]
                   + [(m, kk, nn, block_major_width(nn)) for m, kk, nn in BLOCK_MAJOR])
    worst = 0.0
    k4_graph_ms = {}  # K4's graph time at each row-major shape: K5's yardstick
    for m, kk, nn, bn in w8a8_shapes:
        x, w, s = randint((m, kk)), randint((kk, nn)), scales(nn)
        wl = w if bn is None else lowbit.int8_block_major(w, bn)
        out = w8a8_matmul(x, wl, s)
        again = torch.equal(out, w8a8_matmul(x, wl, s))
        blocks = w8a8_grid(m, kk, nn, bn or nn)
        layout = "row-major" if bn is None else f"block-major BN {bn}"
        worst = max(worst, held(f"w8a8_matmul {layout}", (m, kk, nn), out,
                                w8a8_matmul_reference(x, wl, s)))
        log(f"kernel-experiments: w8a8_matmul (M, K, N)={(m, kk, nn)} same bits on a second "
            f"call {again}; S={blocks[1]} slices of K, grid {blocks} (column tiles, S, row "
            f"blocks)")
        if not again:
            raise RuntimeError(f"w8a8_matmul gives other bits on a second call at {(m, kk, nn)}")
        # torch._int_mm takes M > 16 on CUDA: the rows padded once, outside;
        # its column-major copy of the weight, made once, is for information
        xp = torch.nn.functional.pad(x, (0, 0, 0, max(0, INT_MM_PAD_ROWS - m)))
        w_cm = w.t().contiguous().t()
        times = _kernel_times(lambda: w8a8_matmul(x, wl, s),
                              lambda: w8a8_matmul_reference(x, wl, s),
                              lambda: torch._int_mm(xp, w))
        least = _bound((x, wl, s), (out,), 2 * m * kk * nn, "int8")
        col_major = _graph_ms(lambda: torch._int_mm(xp, w_cm))
        log(f"kernel-experiments: w8a8_matmul time at (M, K, N)={(m, kk, nn)} {layout}: "
            f"{_fmt_times(times)} (library: torch._int_mm alone, no scaling); torch._int_mm "
            f"on a column-major copy of the weight {col_major:.4f} ms (graph); bound "
            f"{least['bound_ms']:.5f} ms ({least['bound_by']}); in a graph the kernel beats "
            f"torch._int_mm: {times['graph_ms'] < times['library_graph_ms']}")
        if bn is None:
            k4_graph_ms[(m, kk, nn)] = times["graph_ms"]
        if "w8a8_matmul" not in entries:
            entries["w8a8_matmul"] = {**times, **least}
    entries["w8a8_matmul"]["max_abs_err"] = worst
    # K5: the split-half int4 product, signed and biased, each the same bits
    # on a second call, its grid and S logged; timed at every shape beside
    # K4 at the same shape (the kernels line's entry: M 8 signed)
    for line in kernels.build_log("int4_split_matmul").splitlines():
        if "registers" in line or "spill" in line:
            log(f"kernel-experiments: int4_split_matmul ptxas {line.strip()}")
    worst = 0.0
    for biased in (False, True):
        pack = lowbit.pack_split_half_biased if biased else lowbit.pack_split_half
        kind = "biased" if biased else "signed"
        for m in ROW_MAJOR_M:
            x, q, s = randint((m, k)), randint((k, n), -8, 8), scales(n)
            packed = pack(q)
            out = int4_split_matmul(x, packed, s, biased)
            again = torch.equal(out, int4_split_matmul(x, packed, s, biased))
            worst = max(worst, held(f"int4_split_matmul {kind}", (m, k, n), out,
                                    int4_split_matmul_reference(x, packed, s, biased)))
            held("int4_split_matmul against the dense int4 weight", (m, k, n), out,
                 (x.double() @ q.double()).float() * s)
            blocks = split_grid(m, k, n)
            log(f"kernel-experiments: int4_split_matmul {kind} (M, K, N)={(m, k, n)} same bits "
                f"on a second call {again}; S={blocks[1]} slices of K/2, grid {blocks} (column "
                f"tiles, S, row blocks)")
            if not again:
                raise RuntimeError(f"int4_split_matmul gives other bits on a second call at "
                                   f"{(m, k, n)} {kind}")
            times = _kernel_times(lambda: int4_split_matmul(x, packed, s, biased),
                                  lambda: int4_split_matmul_reference(x, packed, s, biased))
            least = _bound((x, packed, s), (out,), 2 * m * k * n, "int8")
            yardstick = k4_graph_ms[(m, k, n)]
            log(f"kernel-experiments: int4_split_matmul {kind} time at (M, K, N)={(m, k, n)}: "
                f"{_fmt_times(times)}; bound {least['bound_ms']:.5f} ms ({least['bound_by']}); "
                f"K4 at the same shape {yardstick:.4f} ms (graph); in a graph K5 beats K4: "
                f"{times['graph_ms'] < yardstick}")
            if "int4_split_matmul" not in entries:
                entries["int4_split_matmul"] = {**times, **least}
    entries["int4_split_matmul"]["max_abs_err"] = worst
    # K2 at one group: the adjacent-row (bitcast) packing
    for m in ADJACENT_M:
        x, q, s = randint((m, k)), randint((k, n), -8, 8), scales(n)
        packed = pack_int4(q)
        out = lowbit.int4_adjacent_matmul(x, packed, s)
        relaid = to_block_major(packed, lowbit.adjacent_block_width(n))
        held("int4_matmul at one group (adjacent-row packing)", (m, k, n), out,
             int4_matmul_reference(x, relaid, s))
        held("int4_matmul at one group against the dense int4 weight", (m, k, n), out,
             (x.double() @ q.double()).float() * s)
    # K6: the fused GeGLU FFN, its two phases' geometry and ptxas's lines
    m, h, inter = bench_fused_ffn.M, bench_fused_ffn.H, bench_fused_ffn.I
    (rows, i_tiles), (rows2, s, h_tiles) = ffn_grid(m, h, inter)
    log(f"kernel-experiments: fused_ffn (M, H, I)={(m, h, inter)}: phase 1 (gate, up, "
        f"GeGLU) grid {(rows, i_tiles)} (row blocks of 288, column tiles of 64 of I), no "
        f"cluster; phase 2 (down) grid {(rows2, s, h_tiles)} (row blocks, S={s} slices of K, "
        f"column tiles of 64 of H), cluster (1, {s}, 1)")
    clusters = ffn_clusters()
    log(f"kernel-experiments: fused_ffn phase 2 clusters of 1..8 blocks the card runs at once "
        f"{list(clusters[1:])} (the S rule's table for an H100 SXM: {list(FFN_CLUSTERS[1:])})")
    for line in kernels.build_log("fused_ffn").splitlines():
        if "registers" in line or "spill" in line or "serialized" in line:
            log(f"kernel-experiments: fused_ffn ptxas {line.strip()}")
    x = (torch.rand(m, h, generator=g, device=device) * 2 - 1).to(torch.bfloat16)
    weights = bench_fused_ffn.layer_weights(h, inter, g, device)
    out = fused_ffn(x, *weights)
    ref = fused_ffn_reference(x, *weights).float()
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    bound = bench_fused_ffn.BF16_STEP * ref.abs().max().item()
    again = torch.equal(out, fused_ffn(x, *weights))
    log(f"kernel-experiments: fused_ffn (M, H, I)={(m, h, inter)} max_abs_err={err:.3e} (bound "
        f"one bf16 step at the largest output, {bound:.3e}), same bits on a second call "
        f"{again}")
    if not (torch.isfinite(out).all() and err <= bound and again):
        raise RuntimeError(f"fused_ffn disagrees with its plain version: {err}")
    times = _kernel_times(lambda: fused_ffn(x, *weights), lambda: fused_ffn_reference(x, *weights))
    three = _fmt_times(times, lambda: bench_fused_ffn.ffn_bf16(x, *weights),
                       "the three weights (the FFN)")
    log(f"kernel-experiments: fused_ffn time at (M, H, I)={(m, h, inter)}: {three}")
    _ffn_phase_split(lambda: fused_ffn(x, *weights))
    entries["fused_ffn"] = {"max_abs_err": err, **times,
                            **_bound((x, *weights), (out,), 6 * m * h * inter, "bf16")}
    return entries


def _ffn_phase_split(call, calls: int = 10) -> None:
    """K6's device time split between its two kernels (phase 1: gate, up
    and GeGLU; phase 2: the down product and its cluster merge) under
    torch.profiler, per call over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    phases = {("phase 1 (gate, up, GeGLU)" if "<true>" in e.key else "phase 2 (down, merge)"):
              e.self_device_time_total / calls / 1000.0
              for e in prof.key_averages() if "ffn_kernel" in e.key}
    if len(phases) != 2:
        seen = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        raise RuntimeError(f"the profiler did not see both phases of fused_ffn: {phases} "
                           f"({len(seen)} events with device time)")
    log("kernel-experiments: fused_ffn device time per call under torch.profiler: " +
        ", ".join(f"{name} {ms:.4f} ms" for name, ms in phases.items()) +
        f"; both {sum(phases.values()):.4f} ms")


def experiments_run() -> dict:
    """The two experiment entry points as a user runs them, with the counts
    set to 0 just before; each of their kernels must launch."""
    from blurr_tpu_torch.experiments import bench_fused_ffn, bench_lowbit_matmul

    _zero_counts()
    t0 = time.monotonic()
    if bench_lowbit_matmul.main([]) or bench_fused_ffn.main([]):
        raise RuntimeError("an experiment entry point failed")
    launches = _counts()
    log(f"experiments: both entry points in {time.monotonic() - t0:.2f} s, kernel "
        f"launches {launches}")
    for name in ("w8a8_matmul", "int4_split_matmul", "int4_matmul", "fused_ffn"):
        if not launches[name]:
            raise RuntimeError(f"the experiments never launched {name}")
    return launches


def _kernel_wrappers() -> dict:
    from blurr_tpu_torch.ops.flash_attention import flash_attention
    from blurr_tpu_torch.ops.fused_ffn import fused_ffn
    from blurr_tpu_torch.ops.int4_matmul import int4_matmul
    from blurr_tpu_torch.ops.int4_split_matmul import int4_split_matmul
    from blurr_tpu_torch.ops.int8_matmul import int8_matmul
    from blurr_tpu_torch.ops.w8a8_matmul import w8a8_matmul

    return {"flash_attention": flash_attention, "int4_matmul": int4_matmul,
            "int8_matmul": int8_matmul, "w8a8_matmul": w8a8_matmul,
            "int4_split_matmul": int4_split_matmul, "fused_ffn": fused_ffn}


def _zero_counts() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


def _start(server) -> threading.Thread:
    ready = threading.Event()
    thread = threading.Thread(target=server.serve_forever,
                              kwargs={"port": 0, "ready_event": ready}, daemon=True)
    thread.start()
    if not ready.wait(60):
        raise RuntimeError("server did not start listening")
    return thread


def _stop(server, thread) -> None:
    server.stop()
    thread.join(30)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    if server._batcher is not None:
        server._batcher.join(60)
        if server._batcher.is_alive():
            raise RuntimeError("batcher thread did not stop")


def _check_chunk(label, a) -> None:
    if a.shape != (4, 7) or not np.isfinite(a).all() or np.abs(a).max() > 1.0:
        raise RuntimeError(f"{label}: bad action chunk {a.shape}: {a}")


def _serve_requests(server, cfg, label):
    """N_REQUESTS through the port's ActionClient with the kernel counts set
    to 0 just before; returns the image, the proprio, the counts and the
    actions."""
    from blurr_tpu_torch.serving.client import ActionClient

    thread = _start(server)
    try:
        log(f"{label}: warmup {server.warmup():.2f} s")
        size = cfg["vision"]["config"]["image_size"]
        rng = np.random.RandomState(0)
        image = rng.randint(0, 256, (size, size, 3), np.uint8)
        proprio = rng.uniform(-1, 1, 7).tolist()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        latencies, actions = [], []
        with ActionClient(port=server.port) as client:
            for _ in range(N_REQUESTS):
                t = time.monotonic()
                actions.append(client.predict(image, "put the spoon on the towel", proprio))
                latencies.append((time.monotonic() - t) * 1000.0)
            stats = client.stats()
        launches = _counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        _stop(server, thread)
    for a in actions:
        _check_chunk(label, a)
    if stats["requests_total"] != N_REQUESTS:
        raise RuntimeError(f"{stats['requests_total']} requests served")
    log(f"{label}: {stats['requests_total']} control steps, latency ms per "
        f"request (client) {[round(x, 3) for x in latencies]}, server p50 "
        f"{stats.get('latency_ms_p50')} ms, peak memory {peak / 2**30:.3f} GiB "
        f"({peak} B)")
    log(f"{label}: first action chunk row {np.round(actions[0][0], 4).tolist()}")
    return image, proprio, launches, actions


def _check_launches(label, launches, per_step):
    """Each kernel of ``per_step`` launched that many times per step; every
    other kernel never."""
    for name in KERNEL_NAMES:
        n = per_step.get(name, 0)
        expected = n * N_REQUESTS
        if name in per_step:
            log(f"{label}: {name} launches {launches[name]} (expected {expected} = "
                f"{n} per step x {N_REQUESTS})")
        if launches[name] != expected:
            raise RuntimeError(f"{name} launched {launches[name]} times, not {expected}")


def served_control_steps(device):
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.server import ActionServer

    cfg = load_config("config/eval/bridge.yaml")
    apply_preset(cfg, "blurr")
    cfg["joint"]["config"]["use_flash_attn"] = True
    t0 = time.monotonic()
    server = ActionServer(cfg, "random", device=device, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in server.model.parameters())
    log(f"serve: bridge.yaml blurr preset, {n_params / 1e9:.3f} B params "
        f"{server.dtype} drawn on the card in {time.monotonic() - t0:.2f} s")
    image, proprio, launches, actions = _serve_requests(server, cfg, "serve")
    ONE_RANK["serve"] = (image, proprio, actions, resident_bytes(server.model))
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    # 18 layers, the last computes only K/V
    _check_launches("serve", launches,
                    {"flash_attention": n_layers - 1, "int4_matmul": 0, "int8_matmul": 0})
    _step_device_time(server, image, proprio, "serve", "flash_attention")
    return server, cfg, image, proprio, launches, actions


def served_baseline_steps(device) -> dict:
    """bridge.yaml with the baseline preset (fp32, no prefix cache, 10 flow
    steps): every flow step runs the whole joint model, K1's fp32 kernel
    over 281 rows in each of 18 layers. Then the naive step against the
    cached one (the prefix_cache preset's) on the same weights, inputs and
    noise, and both timed in turns."""
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.server import ActionServer

    cfg = load_config("config/eval/bridge.yaml")
    apply_preset(cfg, "baseline")
    cfg["joint"]["config"]["use_flash_attn"] = True
    t0 = time.monotonic()
    server = ActionServer(cfg, "random", device=device, seed=0)
    torch.cuda.synchronize()
    model = server.model
    log(f"serve-baseline: bridge.yaml baseline preset (use_prefix_kv_cache "
        f"{cfg['use_prefix_kv_cache']}, {model.spec.num_inference_steps} flow steps, "
        f"TF32 {torch.backends.cuda.matmul.allow_tf32}), "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params {server.dtype} "
        f"drawn on the card in {time.monotonic() - t0:.2f} s")
    if server.dtype != torch.float32 or server.prefix_cache:
        raise RuntimeError("the baseline preset does not serve the fp32 naive step")
    image, proprio, launches, _ = _serve_requests(server, cfg, "serve-baseline")
    per_step = cfg["joint"]["config"]["num_hidden_layers"] * model.spec.num_inference_steps
    _check_launches("serve-baseline", launches,
                    {"flash_attention": per_step, "int4_matmul": 0, "int8_matmul": 0})
    _step_median(server, image, proprio, "serve-baseline")
    _step_device_time(server, image, proprio, "serve-baseline", "flash_attention")
    inputs = server._prepare(image, "put the spoon on the towel", proprio)
    noise = server.noise(0)
    steps = {"naive": lambda: model.infer_action_naive(*inputs, noise),
             "cached": lambda: model.infer_action(*inputs, noise)}
    out = {}
    for name, step in steps.items():
        out[name] = step()
    torch.cuda.synchronize()
    diff = (out["naive"] - out["cached"]).abs().max().item()
    log(f"serve-baseline: naive vs cached (prefix_cache preset) control step, the same "
        f"weights, inputs and noise: max_abs_diff={diff:.3e} (tol {BASELINE_TOL:g})")
    if not (torch.isfinite(out["naive"]).all() and diff <= BASELINE_TOL):
        raise RuntimeError(f"the naive and the cached step disagree: {diff}")
    times = {"naive": [], "cached": []}
    for _ in range(3):
        for name in ("naive", "cached", "cached", "naive"):
            t = time.monotonic()
            steps[name]()
            torch.cuda.synchronize()
            times[name].append((time.monotonic() - t) * 1000.0)
    for name, ts in times.items():
        log(f"serve-baseline: fp32 {name} control step ms median {float(np.median(ts)):.3f} "
            f"min {min(ts):.3f} over {len(ts)} (host clock, synchronized)")
    server.prefix_cache = True  # the prefix_cache rung's device time
    _step_device_time(server, image, proprio, "serve-baseline, cached step", "flash_attention")
    return launches


def _same_params(a, b) -> bool:
    pa, pb = list(a.parameters()), list(b.parameters())
    return len(pa) == len(pb) and all(torch.equal(p, q) for p, q in zip(pa, pb))


def served_checkpoint(device, server, cfg, want) -> dict:
    """The blurr server's bf16 weights written as a reference .pt (fp32) to
    a temporary directory; a second server started from that path; its
    parameters and its answers must be the first server's, bit for bit
    (same seed and noise, same kernels). Then, while the file exists,
    serve-reload takes it; then the file is deleted."""
    import shutil

    from blurr_tpu_torch.models.pi0.checkpoint import save_torch_checkpoint
    from blurr_tpu_torch.serving.server import ActionServer

    model = server.model
    fp32_bytes = 4 * sum(p.numel() for p in model.parameters())
    tmp = tempfile.mkdtemp(prefix="blurr_checkpoint_")
    path = os.path.join(tmp, "pi0.pt")
    try:
        log(f"serve-checkpoint: {shutil.disk_usage(tmp).free} B free in {tmp} for "
            f"{fp32_bytes} B of fp32 weights")
        t0 = time.monotonic()
        save_torch_checkpoint(model, path)
        t_write = time.monotonic() - t0
        size = os.path.getsize(path)
        t0 = time.monotonic()
        loaded = ActionServer(cfg, path, device=device, seed=0)
        torch.cuda.synchronize()
        t_load = time.monotonic() - t0
        log(f"serve-checkpoint: wrote {size} B ({size / 1e9:.3f} GB) in {t_write:.2f} s; "
            f"ActionServer(cfg, path) loaded it onto the card as {loaded.dtype} in "
            f"{t_load:.2f} s")
        if loaded.stats()["checkpoint"] != path:
            raise RuntimeError(f"stats name {loaded.stats()['checkpoint']}, not {path}")
        if not _same_params(model, loaded.model):
            raise RuntimeError("the loaded parameters differ from the written ones")
        _, _, launches, actions = _serve_requests(loaded, cfg, "serve-checkpoint")
        n_layers = cfg["joint"]["config"]["num_hidden_layers"]
        _check_launches("serve-checkpoint", launches,
                        {"flash_attention": n_layers - 1, "int4_matmul": 0, "int8_matmul": 0})
        same = [np.array_equal(a, b) for a, b in zip(actions, want)]
        log(f"serve-checkpoint: parameters bit-equal to the drawn ones; answers the same bits "
            f"as the drawing server's: {same}")
        if not all(same):
            raise RuntimeError("the checkpoint server answers other bits")
        del loaded
        _free()
        verify_checkpoint("serve-checkpoint", ["--checkpoint", path, "--kind", "pi0",
                                               "--config", "config/eval/bridge.yaml"])
        reload_launches = served_reload(device, cfg, model, path, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("serve-checkpoint: file deleted")
    return {name: launches[name] + reload_launches[name] for name in KERNEL_NAMES}


def _serve_ctl(*args) -> subprocess.CompletedProcess:
    """scripts/serve_ctl_torch.py run as a user runs it."""
    return subprocess.run([sys.executable, str(REPO_ROOT / "scripts" / "serve_ctl_torch.py"),
                           *map(str, args)], capture_output=True, text=True, timeout=600,
                          cwd=REPO_ROOT)


def served_reload(device, cfg, drawn, path, tmp) -> dict:
    """A blurr server drawn from another seed takes an atomic reload of the
    written .pt through scripts/serve_ctl_torch.py while a client thread
    sends requests the whole time, then a drop_first reload: no request may
    fail, and the parameters must be the written ones bit for bit after
    each. Then a bridge_tiny .pt must be refused (ValueError) with the
    weights still serving, a drop_first reload of a missing path must leave
    "no weights loaded", and an atomic reload must recover."""
    from blurr_tpu_torch.models.pi0.checkpoint import save_torch_checkpoint
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.client import ActionClient
    from blurr_tpu_torch.serving.server import ActionServer

    label = "serve-reload"
    server = ActionServer(cfg, "random", device=device, seed=1)
    if _same_params(drawn, server.model):
        raise RuntimeError(f"{label}: seed 1 drew the weights of seed 0")
    tiny_cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(tiny_cfg, "blurr")
    tiny = PiZero(tiny_cfg, device="cpu", dtype=torch.float32)
    tiny.init_params(torch.Generator().manual_seed(0))
    tiny_path = os.path.join(tmp, "bridge_tiny.pt")
    save_torch_checkpoint(tiny, tiny_path)
    log(f"{label}: warmup {server.warmup():.2f} s")
    thread = _start(server)
    port = server.port
    size = cfg["vision"]["config"]["image_size"]
    image = np.random.RandomState(0).randint(0, 256, (size, size, 3), np.uint8)
    request = (image, "put the spoon on the towel", [0.1] * 7)
    stop, times, errors = threading.Event(), [], []

    def client_loop():
        with ActionClient(port=port) as client:
            while not stop.is_set():
                t = time.monotonic()
                try:
                    _check_chunk(label, client.predict(*request))
                except Exception as exc:  # every failure is a finding: raised below
                    errors.append(repr(exc))
                times.append((t, time.monotonic()))

    loop = threading.Thread(target=client_loop, daemon=True)

    def wait_for(n):
        deadline = time.monotonic() + 120
        while len(times) < n and time.monotonic() < deadline and loop.is_alive():
            time.sleep(0.01)

    def reload(*flags):
        wait_for(len(times) + 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        done = _serve_ctl("reload", path, "--port", port, *flags)
        t1 = time.monotonic()
        peak = torch.cuda.max_memory_allocated()
        wait_for(len(times) + 3)
        across = [(b - a) * 1000.0 for a, b in list(times) if b > t0 and a < t1]
        before = [(b - a) * 1000.0 for a, b in list(times) if b <= t0]
        mode = "drop_first" if flags else "atomic"
        log(f"{label}: {mode} reload through serve_ctl_torch.py: exit {done.returncode}, "
            f"{t1 - t0:.2f} s (the script's process included), answer "
            f"{' '.join(done.stdout.split())!r}; {len(across)} requests across it, the longest "
            f"{max(across, default=0.0):.1f} ms (the median before it "
            f"{float(np.median(before)) if before else 0.0:.1f} ms); memory allocated "
            f"{base} B before, peak {peak} B ({(peak - base) / 1e9:.3f} GB over), on {card()}")
        if done.returncode != 0 or json.loads(done.stdout) != {
                "reloaded": path, "drop_first": bool(flags)}:
            raise RuntimeError(f"{label}: {mode} reload failed: {done.stderr[-2000:]}")
        if not _same_params(drawn, server.model):
            raise RuntimeError(f"{label}: the reloaded parameters are not the written ones")

    try:
        _zero_counts()
        loop.start()
        try:
            reload()
            reload("--drop-first")
        finally:
            stop.set()
            loop.join(120)
        if loop.is_alive():
            raise RuntimeError(f"{label}: the client thread did not stop")
        stats = server.stats()
        log(f"{label}: {len(times)} requests while reloading twice, errors_total "
            f"{stats['errors_total']}, reloads_total {stats['reloads_total']}; parameters "
            f"bit-equal to the written ones after each reload")
        if errors or stats["errors_total"] or stats["reloads_total"] != 2:
            raise RuntimeError(f"{label}: requests failed across a reload: {errors[:3]}")
        with ActionClient(port=port) as client:
            refused = _serve_ctl("reload", tiny_path, "--port", port)
            _check_chunk(label, client.predict(*request))
            log(f"{label}: a bridge_tiny.yaml .pt: exit {refused.returncode}, "
                f"{refused.stderr.strip()[-300:]!r}; the weights still serve, unchanged "
                f"{_same_params(drawn, server.model)}")
            if (refused.returncode != 1 or "ValueError" not in refused.stderr
                    or not _same_params(drawn, server.model)):
                raise RuntimeError(f"{label}: the bridge_tiny .pt was not refused")
            missing = _serve_ctl("reload", os.path.join(tmp, "missing.pt"), "--drop-first",
                                 "--port", port)
            lost = ""
            try:
                client.predict(*request)
            except RuntimeError as exc:  # the server's answer: checked below
                lost = str(exc)
            desc = client.stats()["checkpoint"]
            log(f"{label}: a drop_first reload of a missing path: exit {missing.returncode}; "
                f"checkpoint {desc!r}; a request: {lost!r}")
            if missing.returncode != 1 or "no weights loaded" not in lost or "FAILED" not in desc:
                raise RuntimeError(f"{label}: a failed drop_first did not leave no weights")
            recovered = _serve_ctl("reload", path, "--port", port)
            _check_chunk(label, client.predict(*request))
            stats = client.stats()
        log(f"{label}: an atomic reload recovers: exit {recovered.returncode}, parameters "
            f"bit-equal {_same_params(drawn, server.model)}, checkpoint {stats['checkpoint']!r}")
        if (recovered.returncode != 0 or stats["checkpoint"] != path
                or not _same_params(drawn, server.model)):
            raise RuntimeError(f"{label}: the atomic reload did not recover the server")
        launches = _counts()
    finally:
        _stop(server, thread)
    served = stats["requests_total"]
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    log(f"{label}: flash_attention launches {launches['flash_attention']} (expected "
        f"{(n_layers - 1) * served} = {n_layers - 1} per step x {served} requests served)")
    if launches != {**{n: 0 for n in KERNEL_NAMES}, "flash_attention": (n_layers - 1) * served}:
        raise RuntimeError(f"{label}: launched {launches}")
    del server
    _free()
    return launches


def _concurrent(port, clients: int, requests: int, request_of):
    """``clients`` threads, each with its own ActionClient sending
    ``requests`` requests back to back; returns the wall seconds and
    (client, latency ms, answer or the RuntimeError) per request."""
    from blurr_tpu_torch.serving.client import ActionClient

    out, lock = [], threading.Lock()

    def run(c):
        with ActionClient(port=port) as client:
            for i in range(requests):
                t = time.monotonic()
                try:
                    answer = client.predict(*request_of(c, i))
                except RuntimeError as exc:  # the server's {"error": ...}
                    answer = exc
                with lock:
                    out.append((c, (time.monotonic() - t) * 1000.0, answer))

    threads = [threading.Thread(target=run, args=(c,), daemon=True) for c in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.monotonic() - t0
    if any(t.is_alive() for t in threads) or len(out) != clients * requests:
        raise RuntimeError(f"{len(out)} of {clients * requests} requests came back")
    return wall, out


def _pi0_requests(size, n: int = SERVE_MAX_BATCH):
    """``n`` distinct requests: image, one of 3 instructions, proprio."""
    rng = np.random.RandomState(5)
    instructions = ("put the spoon on the towel", "pick up the carrot",
                    "put the eggplant in the basket")
    return [(rng.randint(0, 256, (size, size, 3), np.uint8), instructions[i % 3],
             rng.uniform(-1, 1, 7).tolist()) for i in range(n)]


def _batched_run(server, label, clients, requests, pool) -> dict:
    """``clients`` concurrent clients, ``requests`` each, over the request
    pool; every answer a finite chunk in [-1, 1]; logs chunks/s, the client p50 / p99 and
    this run's batches, occupancy and padding from stats(). Returns this
    run's counters and answers by pool index."""
    before = server.stats()
    wall, out = _concurrent(server.port, clients, requests,
                            lambda c, i: pool[(c + i) % len(pool)])
    after = server.stats()
    for _, _, a in out:
        if isinstance(a, Exception):
            raise RuntimeError(f"{label}: a request failed: {a}")
        _check_chunk(label, a)
    lat = [ms for _, ms, _ in out]
    run = {k: after.get(k, 0) - before.get(k, 0)
           for k in ("batches_total", "live_slots_total", "padded_slots_total")}
    slots = run["live_slots_total"] + run["padded_slots_total"]
    p50, p99 = np.percentile(lat, [50, 99])
    log(f"{label}: {clients} clients x {requests} requests: {len(out) / wall:.3f} chunks/s "
        f"({len(out)} in {wall:.3f} s), client p50 {p50:.3f} ms p99 {p99:.3f} ms; "
        f"{run['batches_total']} batches, occupancy "
        f"{run['live_slots_total'] / max(1, run['batches_total']):.3f}, padding_frac "
        f"{run['padded_slots_total'] / max(1, slots):.4f} (stats so far: batch_occupancy_mean "
        f"{after.get('batch_occupancy_mean')}, padding_frac {after.get('padding_frac')}); "
        f"host clock, on {card()}")
    if run["live_slots_total"] != len(out):
        raise RuntimeError(f"{label}: {run['live_slots_total']} live slots for {len(out)} requests")
    run["chunks_per_s"] = len(out) / wall
    return run


def _check_batched_launches(label, launches, per_step: dict, batches: int) -> None:
    """Each kernel of ``per_step`` launched that many times per batch;
    every other kernel never."""
    want = {name: per_step.get(name, 0) * batches for name in KERNEL_NAMES}
    for name, n in per_step.items():
        log(f"{label}: {name} launches {launches[name]} (expected {want[name]} = {n} per "
            f"step x {batches} batches)")
    if launches != want:
        raise RuntimeError(f"{label}: launched {launches}, not {want}")


def _warm_buckets(server, label) -> None:
    for b in server._buckets():
        log(f"{label}: warmup of bucket {b}: {server._warm(b):.3f} s")


def served_batched(device) -> dict:
    """bridge.yaml blurr with max_batch 8 under 'pow2': the buckets 1, 2, 4
    and 8 warmed; K1 at the new batch shapes; 1, 2, 4 and 8 concurrent
    clients; each row of one bucket against a batch-1 step on its inputs
    and noise row; a step per bucket under torch.profiler; then 'max' at 3
    clients."""
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.server import ActionServer, _PendingRequest

    label = "serve-batched"
    cfg = load_config("config/eval/bridge.yaml")
    apply_preset(cfg, "blurr")
    cfg["joint"]["config"]["use_flash_attn"] = True
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    server = ActionServer(cfg, "random", device=device, seed=0, max_batch=SERVE_MAX_BATCH,
                          batch_window_ms=BATCH_WINDOW_MS)
    if server._buckets() != [1, 2, 4, 8]:
        raise RuntimeError(f"{label}: buckets {server._buckets()}")
    _warm_buckets(server, label)
    for shape in BATCHED_K1_SHAPES:
        _hold_flash(shape, torch.bfloat16, BF16_TOL, label, device)
    pool = _pi0_requests(cfg["vision"]["config"]["image_size"])
    thread = _start(server)
    try:
        _zero_counts()
        batches = sum(_batched_run(server, label, c, BATCHED_REQUESTS, pool)["batches_total"]
                      for c in CONCURRENCY)
        launches = _counts()
        stats = server.stats()
    finally:
        _stop(server, thread)
    if stats["batches_total"] != batches or stats["errors_total"]:
        raise RuntimeError(f"{label}: stats {stats}")
    _check_batched_launches(label, launches, {"flash_attention": n_layers - 1}, batches)
    # one live bucket of 5 (8 slots), each row against a batch-1 step
    reqs = pool[:5]
    pend = [_PendingRequest(server._prepare(*r)) for r in reqs]
    idx = server._req_idx
    server._run_batch(pend)
    noise = server.noise(idx, SERVE_MAX_BATCH)
    worst = 0.0
    for i, (p, r) in enumerate(zip(pend, reqs)):
        if p.error is not None:
            raise p.error
        alone = server.model.infer_action(*server._prepare(*r), noise[i:i + 1])
        worst = max(worst, float(np.abs(p.result - alone[0].float().cpu().numpy()).max()))
    log(f"{label}: each row of a bucket of 5 live requests (8 slots) against a batch-1 step "
        f"on its inputs and noise row: max_abs_diff={worst:.3e} (tol {BATCHED_TOL:g})")
    if worst > BATCHED_TOL:
        raise RuntimeError(f"{label}: a row of the bucket disagrees with its batch-1 step")
    image, _, proprio = pool[0]
    for b in server._buckets():
        _step_device_time(server, image, proprio, f"{label}, bucket {b}", "flash_attention",
                          batch=b)
    del server, pend
    _free()
    # 'max': every batch padded to max_batch
    server = ActionServer(cfg, "random", device=device, seed=0, max_batch=SERVE_MAX_BATCH,
                          batch_window_ms=BATCH_WINDOW_MS, bucket_mode="max")
    log(f"{label} (max): buckets {server._buckets()}, warmup {server.warmup():.3f} s")
    thread = _start(server)
    try:
        _zero_counts()
        run = _batched_run(server, f"{label} (max)", 3, BATCHED_REQUESTS, pool)
        max_launches = _counts()
        stats = server.stats()
    finally:
        _stop(server, thread)
    want = SERVE_MAX_BATCH * stats["batches_total"] - stats["live_slots_total"]
    log(f"{label} (max): padded_slots_total {stats['padded_slots_total']} (expected {want} = "
        f"{SERVE_MAX_BATCH} x {stats['batches_total']} batches - {stats['live_slots_total']} "
        f"live)")
    if stats["padded_slots_total"] != want or run["batches_total"] != stats["batches_total"]:
        raise RuntimeError(f"{label} (max): stats {stats}")
    _check_batched_launches(f"{label} (max)", max_launches, {"flash_attention": n_layers - 1},
                            stats["batches_total"])
    del server
    _free()
    return {name: launches[name] + max_launches[name] for name in KERNEL_NAMES}


def served_backpressure(device) -> dict:
    """bridge.yaml blurr with max_batch 2 and max_queue 2 under 8 concurrent
    clients: requests are rejected, each rejection reaches its client as an
    "Overloaded" error, and every other answer is a good chunk."""
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.server import ActionServer

    label = "serve-backpressure"
    cfg = load_config("config/eval/bridge.yaml")
    apply_preset(cfg, "blurr")
    cfg["joint"]["config"]["use_flash_attn"] = True
    server = ActionServer(cfg, "random", device=device, seed=0, max_batch=2,
                          batch_window_ms=BATCH_WINDOW_MS, max_queue=2)
    log(f"{label}: max_batch 2, max_queue 2, warmup {server.warmup():.3f} s")
    pool = _pi0_requests(cfg["vision"]["config"]["image_size"])
    thread = _start(server)
    try:
        _zero_counts()
        wall, out = _concurrent(server.port, 8, BACKPRESSURE_REQUESTS,
                                lambda c, i: pool[(c + i) % len(pool)])
        launches = _counts()
        stats = server.stats()
    finally:
        _stop(server, thread)
    rejected = [a for _, _, a in out if isinstance(a, Exception)]
    answered = [a for _, _, a in out if not isinstance(a, Exception)]
    for a in answered:
        _check_chunk(label, a)
    log(f"{label}: 8 clients x {BACKPRESSURE_REQUESTS} requests in {wall:.3f} s: "
        f"{len(answered)} answered, {len(rejected)} rejected (first: "
        f"{str(rejected[0]) if rejected else None!r}); stats rejected_total "
        f"{stats['rejected_total']}, errors_total {stats['errors_total']}, "
        f"batches_total {stats.get('batches_total')}")
    if (not rejected or any("Overloaded" not in str(e) for e in rejected)
            or stats["rejected_total"] != len(rejected)
            or stats["errors_total"] != len(rejected) or not answered
            or stats["requests_total"] != len(answered)):
        raise RuntimeError(f"{label}: backpressure did not hold: {stats}")
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    _check_batched_launches(label, launches, {"flash_attention": n_layers - 1},
                            stats["batches_total"])
    del server
    _free()
    return launches


def served_batched_w4a8(device) -> dict:
    """bridge_pool64_w4a8_steps1.yaml with max_batch 4: every bucket warmed,
    4 concurrent clients; K2 370 and K1 17 times a batch; every K2 shape
    the buckets give that kernel's phase did not hold is held here."""
    from blurr_tpu_torch.ops.int4_matmul import pick_block_layout
    from blurr_tpu_torch.ops.quant import W4A8Linear
    from blurr_tpu_torch.presets import load_config
    from blurr_tpu_torch.serving.server import ActionServer

    label = "serve-batched-w4a8"
    cfg = load_config("config/eval/bridge_pool64_w4a8_steps1.yaml")
    cfg["joint"]["config"]["use_flash_attn"] = True
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    server = ActionServer(cfg, "random", device=device, seed=0, max_batch=4,
                          batch_window_ms=BATCH_WINDOW_MS)
    per_step = launches_per_step(server.model, W4A8Linear)
    if per_step != W4A8_STEP_LAUNCHES:
        raise RuntimeError(f"{label}: {per_step} int4 linears, not {W4A8_STEP_LAUNCHES}")
    pool = _pi0_requests(cfg["vision"]["config"]["image_size"])
    with _RecordInt4Shapes() as served:
        _warm_buckets(server, label)
        thread = _start(server)
        try:
            _zero_counts()
            run = _batched_run(server, label, 4, BATCHED_REQUESTS, pool)
            launches = _counts()
        finally:
            _stop(server, thread)
    _check_batched_launches(label, launches, {"flash_attention": n_layers - 1,
                                              "int4_matmul": per_step}, run["batches_total"])
    del server
    _free()
    held = set()
    for m, k, n, groups in INT4_SHAPES:
        bn, n_pad = pick_block_layout(n)
        held.add((m, k, n_pad, groups, bn))
    served_int4_vs_plain(device, served.seen, held, label, "the buckets 1, 2 and 4",
                         "kernel (the batch-1 step)")
    return launches


def served_openvla_batched(device) -> dict:
    """OpenVLA-7B w4a8 AR with max_batch 4: 4 instructions of different
    token counts, each alone (timed serially), then from 4 concurrent
    clients; each row's tokens must be its solo request's, and a Jacobi
    bucket must give AR's tokens. K2 1,575 times a batch."""
    from blurr_tpu_torch.serving.client import ActionClient

    label = "serve-batched-openvla"
    server = _openvla_server(label, "random-7b", device, quantization="w4a8", max_batch=4,
                             batch_window_ms=BATCH_WINDOW_MS)
    frames = _openvla_frames(3)[:4]
    reqs = [(f, instr, [0.0] * 7) for f, instr in zip(frames, OPENVLA_BATCH_INSTRUCTIONS)]
    prepared = [server._prepare(*r) for r in reqs]
    lengths = [int(p[1].sum()) for p in prepared]
    if len(set(lengths)) != len(reqs):
        raise RuntimeError(f"{label}: prompt lengths {lengths} are not all different")
    _warm_buckets(server, label)
    solo = [server._step(*p) for p in prepared]  # tokens [1, 7] each
    bucket = tuple(torch.cat(parts) for parts in zip(*prepared))
    ar = server._step(*bucket)
    server.decode = "jacobi"
    jacobi = server._step(*bucket)
    server.decode = "ar"
    same = [np.array_equal(ar[i], s[0]) for i, s in enumerate(solo)]
    log(f"{label}: prompt lengths {lengths}; a bucket of the 4 requests against each alone: "
        f"tokens equal {same}; the Jacobi bucket's tokens AR's {np.array_equal(jacobi, ar)}; "
        f"tokens {ar.tolist()}")
    if not all(same) or not np.array_equal(jacobi, ar):
        raise RuntimeError(f"{label}: a bucket's tokens differ from the solo requests'")
    want = {i: server._post(s)[0] for i, s in enumerate(solo)}
    thread = _start(server)
    try:
        t0 = time.monotonic()
        with ActionClient(port=server.port) as client:
            serial = [client.predict(*r) for r in reqs]
        serial_s = time.monotonic() - t0
        log(f"{label}: the 4 requests one after another from one client: "
            f"{len(reqs) / serial_s:.3f} chunks/s ({serial_s:.3f} s; host clock, on {card()})")
        if not all(np.array_equal(a, want[i]) for i, a in enumerate(serial)):
            raise RuntimeError(f"{label}: a serial answer is not its solo step's")
        before = server.stats()["batches_total"]
        _zero_counts()
        wall, out = _concurrent(server.port, 4, OPENVLA_BATCH_REQUESTS,
                                lambda c, i: reqs[c])
        launches = _counts()
        batches = server.stats()["batches_total"] - before
    finally:
        _stop(server, thread)
    for c, _, a in out:
        if isinstance(a, Exception) or not np.array_equal(a, want[c]):
            raise RuntimeError(f"{label}: client {c} got {a}, not its solo answer {want[c]}")
    lat = [ms for _, ms, _ in out]
    log(f"{label}: 4 clients x {OPENVLA_BATCH_REQUESTS} requests: {len(out) / wall:.3f} "
        f"chunks/s ({len(out)} in {wall:.3f} s; serial above {len(reqs) / serial_s:.3f}), "
        f"client p50 {np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} ms, "
        f"{batches} batches, each answer its solo request's; host clock, on {card()}")
    _check_batched_launches(label, launches, {"int4_matmul": OPENVLA_AR_LAUNCHES}, batches)
    del server
    _free()
    return launches


def launches_per_step(model, cls) -> int:
    """The launches in one control step of the kernel behind the linears of
    class ``cls``: the prefill runs the vlm and proprio mixtures' 7 linears
    in every layer but the last, where it runs only q, k and v; each flow
    step runs the action encoder's 3 linears and the action mixture's 7
    linears in every layer."""
    qkv = ("q_proj", "k_proj", "v_proj")
    rest = ("o_proj", "gate_proj", "up_proj", "down_proj")
    encoder = ("action_encoder_w1", "action_encoder_w2", "action_encoder_w3")

    def count(mod, attrs):
        return sum(isinstance(getattr(mod, a), cls) for a in attrs)

    prefill = sum(
        sum(count(layer, qkv + rest) for layer in model.joint[n].layers[:-1])
        + count(model.joint[n].layers[-1], qkv)
        for n in ("vlm", "proprio")
    )
    decode = sum(count(layer, qkv + rest) for layer in model.joint["action"].layers)
    return prefill + model.spec.num_inference_steps * (decode + count(model, encoder))


def resident_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in [*model.parameters(), *model.buffers()])


def _resident_parts(model) -> dict:
    return {
        "embed_tokens": model.embed_tokens.numel() * model.embed_tokens.element_size(),
        "vlm mixture": resident_bytes(model.joint["vlm"]),
        "action mixture": resident_bytes(model.joint["action"]),
        "action encoder": sum(resident_bytes(getattr(model, f"action_encoder_w{i}"))
                              for i in (1, 2, 3)),
        "siglip": resident_bytes(model.vision_tower),
    }


def _step_median(server, image, proprio, label) -> None:
    inputs = server._prepare(image, "put the spoon on the towel", proprio)
    times = []
    for i in range(STEP_MEDIAN_STEPS):
        t = time.monotonic()
        server._step(*inputs, request_idx=i)  # returns host numpy: synchronized
        times.append((time.monotonic() - t) * 1000.0)
    log(f"{label}: control step ms median {float(np.median(times)):.3f} "
        f"min {min(times):.3f} over {len(times)} (host clock, synchronized)")


def _step_device_time(server, image, proprio, label, *names, top: int = 0,
                      batch: int = 1) -> None:
    """One control step under torch.profiler (CUDA activity only): the
    device time of all its kernels and of those of each of ``names`` (the
    names of the port's kernels, e.g. "int4_matmul"); with ``top``, the
    ``top`` kernels launched most often, each with its count and time; at
    ``batch`` > 1, a bucket of that many copies of the request."""
    from torch.profiler import ProfilerActivity, profile

    inputs = server._prepare(image, "put the spoon on the towel", proprio)
    inputs = tuple(torch.cat([a] * batch) for a in inputs)
    server._step(*inputs, request_idx=0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        server._step(*inputs, request_idx=0)
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1000.0
    shares = []
    for name in names:
        ours = [e for e in kernels if name in e.key]
        ours_ms = sum(e.self_device_time_total for e in ours) / 1000.0
        shares.append(f"{name} {ours_ms:.3f} ms ({ours_ms / max(total_ms, 1e-9):.1%}) over "
                      f"{sum(e.count for e in ours)} kernels "
                      f"({', '.join(f'{e.key[:48]} x{e.count}' for e in ours)})")
    log(f"{label}: one control step under torch.profiler: device time {total_ms:.3f} ms over "
        f"{sum(e.count for e in kernels)} kernels; of it {'; '.join(shares)}")
    if top:
        most = sorted(kernels, key=lambda e: -e.count)[:top]
        log(f"{label}: the {top} kernels launched most often: " + "; ".join(
            f"{e.key[:72]} x{e.count} {e.self_device_time_total / 1000.0:.3f} ms" for e in most))
    if not total_ms > 0:
        raise RuntimeError("the profiler saw no device time")


def served_w4a8_steps(device) -> dict:
    from blurr_tpu_torch.ops.quant import W4A8Linear
    from blurr_tpu_torch.presets import load_config
    from blurr_tpu_torch.serving.server import ActionServer

    cfg = load_config("config/eval/bridge_pool64_w4a8_steps1.yaml")
    cfg["joint"]["config"]["use_flash_attn"] = True
    t0 = time.monotonic()
    server = ActionServer(cfg, "random", device=device, seed=0)
    torch.cuda.synchronize()
    model = server.model
    weights = resident_bytes(model)
    log(f"serve-w4a8: bridge_pool64_w4a8_steps1.yaml, random {server.dtype} "
        f"weights drawn on the card and quantized there in "
        f"{time.monotonic() - t0:.2f} s; resident parameters and buffers "
        f"{weights} B ({weights / 1e9:.3f} GB, bound {MAX_W4A8_WEIGHT_BYTES / 1e9:g} GB), "
        f"allocated {torch.cuda.memory_allocated()} B")
    log(f"serve-w4a8: resident bytes by part {_resident_parts(model)}")
    if weights > MAX_W4A8_WEIGHT_BYTES:
        raise RuntimeError(f"resident weights {weights} B over the bound")
    per_step = launches_per_step(model, W4A8Linear)
    if per_step != W4A8_STEP_LAUNCHES:
        raise RuntimeError(f"the pool64 w4a8 step has {per_step} int4 linears, "
                           f"not {W4A8_STEP_LAUNCHES}")
    image, proprio, launches, actions = _serve_requests(server, cfg, "serve-w4a8")
    ONE_RANK["serve-w4a8"] = (image, proprio, actions, weights)
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    _check_launches("serve-w4a8", launches, {"flash_attention": n_layers - 1,
                                             "int4_matmul": per_step, "int8_matmul": 0})
    _step_median(server, image, proprio, "serve-w4a8")
    _step_device_time(server, image, proprio, "serve-w4a8", "int4_matmul", "flash_attention")
    return launches


def served_int8_steps(device, cache_fp: bool) -> dict:
    """bridge_pool64_steps2.yaml at full width: the int8 {q, s} tier
    (``cache_fp=False``) or the preset as shipped (its cached bf16 copy);
    every decode must read an int8 prefix cache."""
    from blurr_tpu_torch.models.pi0 import joint as joint_lib
    from blurr_tpu_torch.ops.quant import CachedFpLinear, Int8Linear
    from blurr_tpu_torch.presets import load_config
    from blurr_tpu_torch.serving.server import ActionServer

    label = "serve-int8-cached" if cache_fp else "serve-int8"
    cfg = load_config("config/eval/bridge_pool64_steps2.yaml")
    if cfg["action_quantization"]["cache_fp_weight"] is not True:
        raise RuntimeError("bridge_pool64_steps2.yaml no longer ships cache_fp_weight: true")
    cfg["action_quantization"]["cache_fp_weight"] = cache_fp
    cfg["joint"]["config"]["use_flash_attn"] = True
    t0 = time.monotonic()
    server = ActionServer(cfg, "random", device=device, seed=0)
    torch.cuda.synchronize()
    model = server.model
    weights = resident_bytes(model)
    log(f"{label}: bridge_pool64_steps2.yaml, cache_fp_weight={cache_fp}, random "
        f"{server.dtype} weights drawn on the card and quantized there in "
        f"{time.monotonic() - t0:.2f} s; resident parameters and buffers "
        f"{weights} B ({weights / 1e9:.3f} GB), allocated "
        f"{torch.cuda.memory_allocated()} B")
    log(f"{label}: resident bytes by part {_resident_parts(model)}")
    kind = CachedFpLinear if cache_fp else Int8Linear
    if launches_per_step(model, kind) != INT8_STEP_LAUNCHES:
        raise RuntimeError(f"the pool64 int8 step has {launches_per_step(model, kind)} "
                           f"{kind.__name__}s, not {INT8_STEP_LAUNCHES}")
    per_step = launches_per_step(model, Int8Linear)
    cache_dtypes = set()
    real_decode = joint_lib.decode

    def recording_decode(*args, **kwargs):
        cache = args[4]
        cache_dtypes.update(t.dtype for entry in cache for t in entry[:2])
        return real_decode(*args, **kwargs)

    joint_lib.decode = recording_decode
    try:
        image, proprio, launches, actions = _serve_requests(server, cfg, label)
        ONE_RANK[label] = (image, proprio, actions, weights)
    finally:
        joint_lib.decode = real_decode
    log(f"{label}: prefix cache k/v dtypes read by the decodes {sorted(map(str, cache_dtypes))}")
    if cache_dtypes != {torch.int8}:
        raise RuntimeError(f"the prefix cache is not held as int8: {cache_dtypes}")
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    _check_launches(label, launches, {"flash_attention": n_layers - 1,
                                      "int4_matmul": 0, "int8_matmul": per_step})
    _step_median(server, image, proprio, label)
    _step_device_time(server, image, proprio, label, "int8_matmul", "flash_attention")
    return launches


def model_kernel_vs_plain(server, image, proprio) -> None:
    """One control step on the served weights with and without the kernel;
    then the step's time both ways (host clock around a synchronized step,
    alternating kernel / plain)."""
    model = server.model
    inputs = server._prepare(image, "put the spoon on the towel", proprio)
    flash_spec = model.joint_spec
    plain_spec = dataclasses.replace(flash_spec, use_flash_attn=False)

    def step(spec):
        model.joint_spec = spec
        out = model.infer_action(*inputs, server.noise(0))
        torch.cuda.synchronize()
        return out

    try:
        a_flash, a_plain = step(flash_spec), step(plain_spec)
        diff = (a_flash.float() - a_plain.float()).abs().max().item()
        log(f"model: actions kernel vs plain attention max_abs_diff={diff:.3e} "
            f"(bound {MODEL_TOL:g})")
        if not (np.isfinite(diff) and diff <= MODEL_TOL):
            raise RuntimeError(f"kernel and plain control steps disagree: {diff}")
        times = {"kernel": [], "plain": []}
        for _ in range(5):
            for name, spec in (("kernel", flash_spec), ("plain", plain_spec),
                               ("plain", plain_spec), ("kernel", flash_spec)):
                t = time.monotonic()
                step(spec)
                times[name].append((time.monotonic() - t) * 1000.0)
        for name, ts in times.items():
            log(f"model: control step with {name} attention, ms median "
                f"{float(np.median(ts)):.3f} min {min(ts):.3f} over {len(ts)} "
                "(host clock, synchronized)")
    finally:
        model.joint_spec = flash_spec


def small_model_vs_cpu(device, quant: str = "", adaptive: str = "") -> None:
    """The small model on the card against the same weights on the CPU;
    with ``quant="w4a8"`` both hold the same w4a8 weights (quantized once,
    on the CPU), vlm and action mixtures through the int4 kernel and
    SigLIP w8a8; with ``quant="int8"`` the action expert is int8 {q, s}
    through the int8 kernel and the prefix cache is int8 (clip 1.0,
    dequantized to bf16). With ``adaptive="adaLN-Zero"`` the action expert
    is adaptive (its gates' weights redrawn, JAX's init leaves them 0), and
    the naive step is held too."""
    from blurr_tpu_torch.models.pi0.joint import AdaptiveLayerscale
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.ops.quant import Int8Linear, W4A8Linear
    from blurr_tpu_torch.presets import apply_preset, load_config

    label, tol = {"": ("small", SMALL_TOL), "w4a8": ("small-w4a8", SMALL_W4A8_TOL),
                  "int8": ("small-int8", SMALL_INT8_TOL)}[quant]
    cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(cfg, "prefix_cache")  # fp32, prefix cache, 10 flow steps
    cfg["max_image_text_tokens"] = cfg["max_seq_len"] = 80
    cfg["joint"]["config"]["use_flash_attn"] = True
    if adaptive:
        label = f"{label}-{adaptive}"
        cfg["action_expert_adaptive_mode"] = adaptive
        for mix in ("proprio", "action"):
            cfg["joint"]["config"]["mixture"][mix]["adaptive_mode"] = adaptive
    if quant == "w4a8":
        cfg["vlm_quantization"] = {"mode": quant, "include_vision": True}
        cfg["action_quantization"] = {"mode": quant, "activation_clip": None}
    elif quant == "int8":
        cfg["action_quantization"] = {"mode": "int8", "activation_clip": 1.0,
                                      "cache_fp_weight": False}
        cfg["kv_quantization"] = {"mode": "int8", "activation_clip": 1.0,
                                  "dtype": "bfloat16"}
    cpu = PiZero(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for mod in cpu.modules():
            if isinstance(mod, AdaptiveLayerscale):
                mod.gamma.weight.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(1))
    cpu.enable_action_quantization()
    cpu.enable_vlm_quantization()
    gpu = copy.deepcopy(cpu).to(device)
    s = cpu.spec
    n_img = cfg["vision"]["config"]["num_image_tokens"]
    size = cfg["vision"]["config"]["image_size"]
    rng = np.random.RandomState(0)
    ids = np.zeros((2, 80), np.int64)
    am = np.zeros((2, 80), np.int32)
    ids[:, :n_img] = s.image_token_index
    for b, n_valid in enumerate((n_img + 9, n_img + 30)):  # pad rows follow
        ids[b, n_img:n_valid] = rng.randint(3, 1000, n_valid - n_img)
        am[b, :n_valid] = 1
    inputs = [
        torch.from_numpy(ids), torch.from_numpy(am),
        torch.from_numpy(rng.uniform(-1, 1, (2, 3, size, size)).astype(np.float32)),
        torch.from_numpy(rng.randn(2, 1, s.proprio_dim).astype(np.float32)),
        torch.from_numpy(rng.randn(2, 4, s.action_dim).astype(np.float32)),
    ]
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    # the naive step attends over 85 rows in every layer of every flow step
    flash = {"infer_action": n_layers - 1,
             "infer_action_naive": n_layers * s.num_inference_steps}
    for infer in ("infer_action", "infer_action_naive") if adaptive else ("infer_action",):
        ref = getattr(cpu, infer)(*inputs)
        _zero_counts()
        out = getattr(gpu, infer)(*(t.to(device) for t in inputs))
        torch.cuda.synchronize()
        launches = _counts()
        expected = {name: 0 for name in KERNEL_NAMES}
        expected.update({"flash_attention": flash[infer],
                         "int4_matmul": launches_per_step(gpu, W4A8Linear),
                         "int8_matmul": launches_per_step(gpu, Int8Linear)})
        err = (out.cpu() - ref).abs().max().item()
        log(f"{label}: fp32 bridge_tiny widths, prefix 81, {infer}, card vs CPU actions "
            f"max_abs_err={err:.3e} (tol {tol:g}), kernel launches {launches} "
            f"(expected {expected})")
        if not (torch.isfinite(out).all() and err <= tol):
            raise RuntimeError(f"card and CPU disagree on the {label} model: {err}")
        if launches != expected:
            raise RuntimeError(f"the {label} model launched {launches}, not {expected}")
    if quant == "int8":
        _int8_rounding_witness(cpu, gpu, inputs, device)


def _int8_rounding_witness(cpu, gpu, inputs, device) -> None:
    """small-int8's second witness: record the CPU's int8 prefix cache and
    the int8 kernel's inputs, then run the card again giving it the CPU's
    value wherever its own rounds the other way (a cached K/V value to
    another int8 step, a kernel input to another bf16). What is left is the
    fp32 summation order, held to SMALL_TOL."""
    from blurr_tpu_torch.models.pi0 import pizero
    from blurr_tpu_torch.ops import quant

    real_cache, real_mm = pizero._quantize_cache, quant.int8_mm_nd
    caches, xs = [], []
    flips = {"cached K/V values": 0, "kernel inputs": 0}

    def record_cache(cache, clip):
        caches.append(real_cache(cache, clip))
        return caches[-1]

    def record_mm(x, w):
        xs.append(x)
        return real_mm(x, w)

    def repair_cache(cache, clip):
        out = []
        for mine, theirs in zip(real_cache(cache, clip), caches[0]):
            k, v = theirs.k.to(device), theirs.v.to(device)
            flips["cached K/V values"] += int((mine.k != k).sum() + (mine.v != v).sum())
            out.append(mine._replace(k=k, v=v))
        return out

    cpu_xs = iter(xs)

    def repair_mm(x, w):
        theirs = next(cpu_xs).to(device)
        flip = x.bfloat16() != theirs.bfloat16()
        flips["kernel inputs"] += int(flip.sum())
        return real_mm(torch.where(flip, theirs, x), w)

    try:
        pizero._quantize_cache, quant.int8_mm_nd = record_cache, record_mm
        ref = cpu.infer_action(*inputs)
        pizero._quantize_cache, quant.int8_mm_nd = repair_cache, repair_mm
        out = gpu.infer_action(*(t.to(device) for t in inputs))
        torch.cuda.synchronize()
    finally:
        pizero._quantize_cache, quant.int8_mm_nd = real_cache, real_mm
    err = (out.cpu() - ref).abs().max().item()
    n_values = sum(e.k.numel() + e.v.numel() for e in caches[0])
    n_inputs = sum(x.numel() for x in xs)
    log(f"small-int8: with the CPU's rounding where the card's differs "
        f"({flips['cached K/V values']} of {n_values} cached K/V values, "
        f"{flips['kernel inputs']} of {n_inputs} kernel inputs) card vs CPU "
        f"max_abs_err={err:.3e} (tol {SMALL_TOL:g})")
    if not (torch.isfinite(out).all() and err <= SMALL_TOL):
        raise RuntimeError(f"card and CPU disagree on the small-int8 model "
                           f"with the roundings repaired: {err}")


# --------------------------------------------------------------------------
# the closed-loop eval path: the agents on the fake env, the in-graph resize,
# the eval CLI
# --------------------------------------------------------------------------

EVAL_TASK = "fake_widowx_carrot_on_plate"
# the batched bf16 step (M = 4 x 277 rows in every GEMM) against the batch-1
# step on each row's inputs and noise: cuBLAS may pick other algorithms at
# the larger M, so the bf16 roundings differ through 27 + 18 layers, as
# between K1 and the plain attention (MODEL_TOL)
BATCHED_TOL = MODEL_TOL
# the in-graph lanczos3 resize of a 480x640 frame to 224 on the card (fp32
# matmuls, TF32 off) against the CPU's, in the normalized pixel values
FRAME_TOL = 1e-5


class _Lines(logging.Handler):
    """Every log record's message from INFO up, in order."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run_logged(run):
    """``run()`` with the root logger's INFO records collected; returns
    (its result, the messages)."""
    root, handler = logging.getLogger(), _Lines()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        return run(), handler.lines
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


def _eval_cfg(config: str, log_dir: str, **extra):
    from blurr_tpu_torch.presets import apply_preset, load_config

    cfg = load_config(config)
    apply_preset(cfg, "blurr")
    cfg["joint"]["config"]["use_flash_attn"] = True
    cfg["env"]["task"] = EVAL_TASK
    cfg.update({"n_eval_episode": 2, "n_video": 0, "seed": 42, "checkpoint_path": "random",
                "log_dir": log_dir, **extra})
    return cfg


def _recording(agent, real, records: list):
    """``real`` (a dispatch method) that appends each dispatch's (host
    inputs, dispatch index, device output) to ``records``."""

    def recording(inputs):
        idx = agent._step_idx
        out = real(inputs)
        records.append((inputs, idx, out))
        return out

    return recording


def _record_fetches(agent) -> list:
    """The host chunks the agent's ``_fetch`` returns, in order."""
    chunks, real = [], agent._fetch

    def recording(pending):
        chunks.append(real(pending))
        return chunks[-1]

    agent._fetch = recording
    return chunks


def _check_summary(label, lines, episodes: int, rate: float) -> None:
    want = [f"Number of episodes: {episodes}", f"Success rate: {rate}"]
    for line in want:
        if line not in lines:
            raise RuntimeError(f"{label}: the summary line {line!r} is missing")
    log(f"{label}: summary lines {want}")
    for line in lines:
        if line.startswith(("Inference wall-clock", "Async pipeline", "Batched eval",
                            "Allocated device memory after evaluation")):
            log(f"{label}: {line}")


def _check_eval_launches(label, launches, per_step: dict, steps: int) -> None:
    expected = {name: per_step.get(name, 0) * steps for name in KERNEL_NAMES}
    log(f"{label}: kernel launches {launches} (expected {expected}: "
        f"{per_step} per control step x {steps} control steps)")
    if launches != expected:
        raise RuntimeError(f"{label}: launched {launches}, not {expected}")


def _check_bitwise(label, agent, records) -> None:
    """Every dispatched chunk equals ``infer_action`` called directly on the
    same inputs and noise, bit for bit."""
    for inputs, idx, out in records:
        ref = agent.model.infer_action(*agent.device_inputs(inputs), agent.noise(idx, 1))
        if not torch.equal(ref, out):
            raise RuntimeError(f"{label}: dispatch {idx} differs from infer_action: "
                               f"{(ref.float() - out.float()).abs().max().item()}")
    log(f"{label}: all {len(records)} dispatched chunks bit-equal to infer_action called "
        f"directly on the same inputs and noise")


def eval_agent_new(device, label: str, log_dir: str,
                   config: str = "config/eval/bridge.yaml", **extra):
    """EvalAgent on the fake env at full width with random weights drawn on
    the card; fails if its quantization fell back to unquantized weights."""
    from blurr_tpu_torch.agent.eval_agent import EvalAgent

    cfg = _eval_cfg(config, log_dir, **extra)
    t0 = time.monotonic()
    agent, init_lines = _run_logged(lambda: EvalAgent(cfg, device=device))
    torch.cuda.synchronize()
    if any("Quantization failed" in line for line in init_lines):
        raise RuntimeError(f"{label}: the agent fell back to unquantized weights")
    log(f"{label}: {Path(config).name}, blurr preset, act_steps {agent.act_steps}, "
        f"{sum(p.numel() for p in agent.model.parameters()) / 1e9:.3f} B params "
        f"{agent.dtype} drawn on the card in {time.monotonic() - t0:.2f} s")
    return agent


def eval_agent_run(agent, label: str):
    """One run of the agent (2 episodes, 12 env steps each), the counts set
    to 0 just before it; checks the summary lines, K1's launches (and K2's
    under w4a8) and every chunk bit-equal to a direct infer_action. Returns
    the resize rung lines logged and the launches."""
    from blurr_tpu_torch.ops.quant import W4A8Linear

    records = []
    agent._dispatch = _recording(agent, type(agent)._dispatch.__get__(agent), records)
    agent._step_idx = 0
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    rate, lines = _run_logged(agent.run)
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: async pipeline {agent.async_pipeline}")
    rungs = [line for line in lines if line.startswith("lanczos_resize_uint8: the ")]
    if rungs:
        log(f"{label}: resize rung logged: {rungs[0]}")
    _check_summary(label, lines, 2, 0.5)
    log(f"{label}: peak memory {peak} B ({peak / 2**30:.3f} GiB) on {card()}")
    n_layers = agent.cfg["joint"]["config"]["num_hidden_layers"]
    per_step = {"flash_attention": n_layers - 1,
                "int4_matmul": launches_per_step(agent.model, W4A8Linear)}
    _check_eval_launches(label, launches, per_step, agent._step_idx)
    _check_bitwise(label, agent, records)
    return lines, rungs, launches


def eval_agent_blurr(device, log_dir: str):
    agent = eval_agent_new(device, "eval-agent", log_dir, act_steps=4,
                           record_dataset_dir=os.path.join(log_dir, "recorded_serial"))
    _, rungs, launches = eval_agent_run(agent, "eval-agent")
    if not rungs:
        raise RuntimeError("eval-agent: no resize rung was logged")
    _check_recorded("eval-agent", agent, agent._step_idx)
    inputs = _first_inputs(agent)
    _agent_step_times("eval-agent", "the agent's control step", lambda: agent._infer(inputs))
    _resize_rungs(agent)
    return agent, launches


def _agent_step_times(label, what: str, step, n: int = AGENT_TIMED_STEPS) -> float:
    """``step()`` (host inputs up, the eager dispatch, the chunk fetched)
    timed n times on the host clock after one untimed call; logs the median,
    min and max beside n and returns the median in ms."""
    step()
    times = []
    for _ in range(n):
        t = time.monotonic()
        step()
        times.append((time.monotonic() - t) * 1000.0)
    median = float(np.median(times))
    log(f"{label}: {what}: median {median:.3f} ms, min {min(times):.3f}, max "
        f"{max(times):.3f} over n={n} (host clock, synchronized by the fetch)")
    return median


def _first_inputs(agent) -> dict:
    obs, _ = agent.env.reset(options={"obj_init_options": {"episode_id": 0}})
    return agent.env_adapter.preprocess(agent.env, obs, agent.env.get_language_instruction())


def _resize_rungs(agent) -> None:
    """Each rung of the host resize ladder on a fake-env frame, timed on
    the host (median of 20): cv2 where the machine has it, the native
    library (built here), the torch rung."""
    from blurr_tpu_torch import native
    from blurr_tpu_torch.utils import image

    obs, _ = agent.env.reset(options={"obj_init_options": {"episode_id": 0}})
    frame = obs["image"]
    size = agent.model.vision_cfg["image_size"]
    found = native.library_path().is_file()
    t0 = time.monotonic()
    built = native.available()
    log(f"eval-agent: native rung available={built} ({'found built' if found else 'built'} "
        f"at {native.library_path().relative_to(REPO_ROOT)}, {time.monotonic() - t0:.2f} s "
        f"to build and load); cv2 {getattr(image.cv2, '__version__', None)}")
    rungs = {"torch": lambda: image._torch_rung(frame, size, size)}
    if image.cv2 is not None:
        rungs["cv2"] = lambda: image.cv2.resize(frame, (size, size),
                                                interpolation=image.cv2.INTER_LANCZOS4)
    if built:
        rungs["native"] = lambda: native.lanczos4_resize(frame, (size, size))
    for name, fn in rungs.items():
        times = []
        for _ in range(20):
            t = time.monotonic()
            fn()
            times.append((time.monotonic() - t) * 1000.0)
        log(f"eval-agent: {name} rung {frame.shape[:2]} -> {size}x{size}: median "
            f"{float(np.median(times)):.3f} ms over 20 (host clock)")


def _free() -> None:
    """Release the memory of a dropped agent: its recording wrappers hold
    it in a reference cycle."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def eval_agent_async(agent) -> dict:
    """Phase 14's agent again with the async pipeline on; then one more
    dispatch under torch.cuda.set_sync_debug_mode("warn"): nothing in it may
    synchronize, and its host time is set beside the fetch that waits for
    the device."""
    import warnings

    agent.async_pipeline = True
    agent.record_dir = os.path.join(os.path.dirname(agent.record_dir), "recorded_async")
    agent._recorded = []
    fetched = _record_fetches(agent)
    lines, _, launches = eval_agent_run(agent, "eval-agent-async")
    if not any(line.startswith("Async pipeline: residual fetch wait") for line in lines):
        raise RuntimeError("eval-agent-async: no residual-fetch line")
    _check_recorded("eval-agent-async", agent, len(fetched))
    inputs = _first_inputs(agent)
    agent._fetch(agent._dispatch(inputs))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.monotonic()
            pending = agent._dispatch(inputs)
            t_dispatch = time.monotonic() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    t0 = time.monotonic()
    agent._fetch(pending)
    t_fetch = time.monotonic() - t0
    # the notice set_sync_debug_mode itself gives when turned on is no sync
    syncs = [str(w.message).splitlines()[0] for w in caught
             if not str(w.message).startswith("Synchronization debug mode is a prototype")]
    log(f"eval-agent-async: one dispatch under set_sync_debug_mode('warn'): "
        f"{len(syncs)} synchronizing operations {syncs[:3]}; dispatch returned in "
        f"{t_dispatch * 1000:.3f} ms, the fetch then waited {t_fetch * 1000:.3f} ms "
        f"(host clock, one dispatch)")
    if syncs:
        raise RuntimeError("eval-agent-async: the dispatch synchronizes the host")
    return launches


def eval_agent_batched(device) -> dict:
    """BatchedEvalAgent, 4 envs in lockstep over 4 episodes; each row of
    every batched chunk against the batch-1 step on that row's inputs and
    noise (BATCHED_TOL)."""

    from blurr_tpu_torch.agent.batched_eval import BatchedEvalAgent

    label = "eval-batched"
    with tempfile.TemporaryDirectory(prefix="blurr_eval_") as tmp:
        cfg = _eval_cfg("config/eval/bridge.yaml", tmp, act_steps=4, batch_envs=4,
                        n_eval_episode=4)
        agent = BatchedEvalAgent(cfg, device=device)
        records = []
        agent._dispatch_batched = _recording(agent, agent._dispatch_batched, records)
        _zero_counts()
        rate, lines = _run_logged(agent.run)
        torch.cuda.synchronize()
        launches = _counts()
    _check_summary(label, lines, 4, 0.5)
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    _check_eval_launches(label, launches, {"flash_attention": n_layers - 1}, agent._step_idx)
    err = 0.0
    for slot_inputs, idx, out in records:
        noise = agent.noise(idx, len(slot_inputs))
        for i, inputs in enumerate(slot_inputs):
            ref = agent.model.infer_action(*agent.device_inputs(inputs), noise[i:i + 1])
            err = max(err, (ref[0].float() - out[i].float()).abs().max().item())
    log(f"{label}: {len(records)} batched steps of {len(records[0][0])} rows, each row "
        f"against the batch-1 step on its inputs and noise: max_abs_err={err:.3e} "
        f"(tol {BATCHED_TOL:g})")
    if not err <= BATCHED_TOL:
        raise RuntimeError(f"{label}: batched rows disagree with batch 1: {err}")
    inputs = records[0][0]
    batched = _agent_step_times(label, f"one lockstep round of {len(inputs)} envs",
                                lambda: agent._batched_infer(inputs))
    single = _agent_step_times(label, "one batch-1 step of the same agent",
                               lambda: agent._infer(inputs[0]))
    log(f"{label}: the round of {len(inputs)} costs {batched / single:.3f} batch-1 steps")
    return launches


def eval_agent_w4a8(device, log_dir: str) -> dict:
    """bridge_pool64_w4a8_steps1.yaml through the agent (act_steps 1 as
    shipped): 370 int4 linears per step, no quantization fallback."""
    from blurr_tpu_torch.ops.quant import W4A8Linear

    agent = eval_agent_new(device, "eval-agent-w4a8", log_dir,
                           "config/eval/bridge_pool64_w4a8_steps1.yaml")
    _, _, launches = eval_agent_run(agent, "eval-agent-w4a8")
    inputs = _first_inputs(agent)
    _agent_step_times("eval-agent-w4a8", "the agent's control step",
                      lambda: agent._infer(inputs))
    per_step = launches_per_step(agent.model, W4A8Linear)
    if per_step != W4A8_STEP_LAUNCHES:
        raise RuntimeError(f"eval-agent-w4a8: {per_step} int4 linears per step, "
                           f"not {W4A8_STEP_LAUNCHES}")
    return launches


def from_frame(device, agent) -> dict:
    """infer_action_from_frame on the fake env's 480x640 frame on the card:
    the resized, normalized pixel values against the CPU's (FRAME_TOL), and
    the step bit-equal to infer_action on the card's pixel values."""
    from blurr_tpu_torch.utils.image import lanczos_resize

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("from-frame: TF32 is on")
    model = agent.model
    obs, _ = agent.env.reset(options={"obj_init_options": {"episode_id": 0}})
    inputs = agent.env_adapter.preprocess(agent.env, obs, agent.env.get_language_instruction())
    ids, am, _, pr = agent.device_inputs(inputs)
    frame = torch.from_numpy(obs["image"])[None]
    size = model.vision_cfg["image_size"]

    def normalized(x):
        return (lanczos_resize(x.float(), size, size, 3) / 255.0 - 0.5) / 0.5

    px_card = normalized(frame.to(device))
    err = (px_card.cpu() - normalized(frame)).abs().max().item()
    noise = agent.noise(0, 1)
    _zero_counts()
    out = model.infer_action_from_frame(ids, am, frame.to(device), pr, noise)
    torch.cuda.synchronize()
    launches = _counts()
    ref = model.infer_action(ids, am, px_card.permute(0, 3, 1, 2).to(pr.dtype), pr, noise)
    log(f"from-frame: {tuple(frame.shape)} uint8 frame resized to {size}x{size} on the card "
        f"(lanczos3, fp32, TF32 off): pixel values vs the CPU max_abs_err={err:.3e} (tol "
        f"{FRAME_TOL:g}); the step bit-equal to infer_action on them: "
        f"{torch.equal(out, ref)}; kernel launches {launches}")
    if not err <= FRAME_TOL:
        raise RuntimeError(f"from-frame: the card's resize disagrees with the CPU's: {err}")
    if not torch.equal(out, ref) or out.shape != (1, 4, 7):
        raise RuntimeError("from-frame: the step differs from infer_action")
    n_layers = agent.cfg["joint"]["config"]["num_hidden_layers"]
    _check_eval_launches("from-frame", launches, {"flash_attention": n_layers - 1}, 1)
    return launches


def eval_cli() -> None:
    """The port's eval CLI as a user runs it, in a subprocess on the card:
    exit 0 and both summary lines in its run.log."""
    import subprocess

    with tempfile.TemporaryDirectory(prefix="blurr_cli_") as tmp:
        cmd = [sys.executable, "scripts/eval_pi0_simpler_torch.py", "--task", EVAL_TASK,
               "--checkpoint", "random", "--config",
               "config/eval/bridge_pool64_w4a8_steps1.yaml", "--preset", "blurr",
               "--n-eval-episode", "2", "--log-dir", tmp]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)
        secs = time.monotonic() - t0
        run_log = Path(tmp) / "run.log"
        text = run_log.read_text() if run_log.is_file() else ""
    log(f"eval-cli: {' '.join(cmd[1:])} -> exit {proc.returncode} in {secs:.1f} s")
    if proc.returncode != 0:
        raise RuntimeError(f"eval-cli failed:\n{proc.stderr[-3000:]}")
    for want in ("Number of episodes: 2", "Success rate: 0.5"):
        if want not in text:
            raise RuntimeError(f"eval-cli: {want!r} missing from run.log")
    if "Quantization failed" in text:
        raise RuntimeError("eval-cli: the agent fell back to unquantized weights")
    for line in text.splitlines():
        if any(k in line for k in ("Number of episodes", "Success rate", "Inference wall",
                                   "Using device", "Allocated device memory", " rung ")):
            log(f"eval-cli: run.log: {line.split(' | ')[-1]}")


def small_agent_vs_cpu(device) -> dict:
    """bridge_tiny.yaml (80-token prefix, so the prefill takes K1), fp32,
    prefix_cache preset: the same weights in an agent on the CPU and one on
    the card, the same summary lines and every chunk within SMALL_TOL."""

    from blurr_tpu_torch.agent.eval_agent import EvalAgent
    from blurr_tpu_torch.presets import apply_preset

    chunks = {}
    with tempfile.TemporaryDirectory(prefix="blurr_eval_") as tmp:
        agents = {}
        for where in ("cpu", "card"):
            cfg = _eval_cfg("config/eval/bridge_tiny.yaml", tmp)
            apply_preset(cfg, "prefix_cache")
            cfg["max_image_text_tokens"] = cfg["max_seq_len"] = 80
            cfg["env"]["adapter"]["max_seq_len"] = 80
            agents[where] = EvalAgent(cfg, device="cpu" if where == "cpu" else device)
        with torch.no_grad():
            for p, q in zip(agents["card"].model.parameters(), agents["cpu"].model.parameters()):
                p.copy_(q)
        results = {}
        for where, agent in agents.items():
            chunks[where] = _record_fetches(agent)
            _zero_counts()
            results[where] = _run_logged(agent.run)
        torch.cuda.synchronize()
        launches = _counts()  # the CPU's run launches no kernel
    summaries = {w: [line for line in lines if line.startswith(("Number of ep", "Success"))]
                 for w, (_, lines) in results.items()}
    err = max(np.abs(a - b).max() for a, b in zip(chunks["card"], chunks["cpu"]))
    log(f"small-agent: bridge_tiny widths, prefix 81, fp32, 10 flow steps, card vs CPU: "
        f"summaries {summaries['card']} / {summaries['cpu']}, {len(chunks['card'])} chunks "
        f"max_abs_err={err:.3e} (tol {SMALL_TOL:g}), card launches {launches}")
    if summaries["card"] != summaries["cpu"] or len(chunks["card"]) != len(chunks["cpu"]):
        raise RuntimeError("small-agent: the card's run differs from the CPU's")
    if not err <= SMALL_TOL:
        raise RuntimeError(f"small-agent: card and CPU chunks disagree: {err}")
    n_layers = agents["card"].cfg["joint"]["config"]["num_hidden_layers"]
    _check_eval_launches("small-agent", launches, {"flash_attention": n_layers - 1},
                         agents["card"]._step_idx)
    return launches


# --------------------------------------------------------------------------
# the text-generation path: Pi-0's text mode, PaliGemma-3B and Gemma from
# safetensors shards, the small text models card against CPU
# --------------------------------------------------------------------------


def _median_ms(times) -> str:
    return f"median {float(np.median(times)):.3f} ms over n={len(times)}"


def _text_prompt(batch: int, q_len: int, n_img: int, image_token: int, seed: int):
    """Image tokens, BOS, random text ids; numpy int64 [batch, q_len]."""
    rng = np.random.RandomState(seed)
    ids = np.full((batch, q_len), image_token, np.int64)
    ids[:, n_img] = 2
    ids[:, n_img + 1:] = rng.randint(3, 256000, (batch, q_len - n_img - 1))
    return ids


def _pi0_text_run(model, ids, px, am=None, timed: bool = False):
    """Pi-0's prefill and TEXT_NEW_TOKENS - 1 greedy decode steps, with the
    counts set to 0 just before; returns the tokens [B, T] (host), the
    launches of the prefill and of the whole run, and the prefill's and
    each decode step's ms (host clock, synchronized, when ``timed``)."""
    _zero_counts()
    t0 = time.monotonic()
    logits, cache, n = model.infer_text_prefill(ids, px, ids.shape[1] + TEXT_NEW_TOKENS, am)
    tok = logits[:, -1].argmax(-1)
    if timed:
        torch.cuda.synchronize()
    t_prefill = (time.monotonic() - t0) * 1000.0
    prefill = _counts()
    toks, steps = [tok], []
    for _ in range(TEXT_NEW_TOKENS - 1):
        t0 = time.monotonic()
        tok, cache, n = model.infer_text_decode_step(tok, cache, n, am)
        if timed:
            torch.cuda.synchronize()
        steps.append((time.monotonic() - t0) * 1000.0)
        toks.append(tok)
    out = torch.stack(toks, 1).cpu().numpy()
    return out, prefill, _counts(), t_prefill, steps


def _pi0_forced_logits(model, ids, px, tokens, am=None) -> torch.Tensor:
    """Pi-0's prefill logits and its decode logits teacher-forced on
    ``tokens`` [B, TEXT_NEW_TOKENS]: fp32 [B, TEXT_NEW_TOKENS, V]."""
    out, cache, n = model.infer_text_prefill(ids, px, ids.shape[1] + TEXT_NEW_TOKENS, am)
    outs = [out]
    for i in range(TEXT_NEW_TOKENS - 1):
        out, cache, n = model.text_decode_logits(tokens[:, i], cache, n, am)
        outs.append(out)
    return torch.cat(outs, 1).float()


def _profile_text(label, what: str, call, *names) -> None:
    """One ``call()`` under torch.profiler (CUDA activity): its device time
    and kernel count beside its host time, which gives the device's busy
    share of that call; and the share of each of the port's kernels
    ``names`` (e.g. "int4_matmul")."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        call()
        torch.cuda.synchronize()
        host_ms = (time.monotonic() - t0) * 1000.0
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1000.0
    shares = ""
    for name in names:
        ours = [e for e in kernels if name in e.key]
        shares += (f"; {name} {sum(e.self_device_time_total for e in ours) / 1000.0:.3f} ms "
                   f"of it over {sum(e.count for e in ours)} kernels")
    log(f"{label}: {what} under torch.profiler: device time {device_ms:.3f} ms over "
        f"{sum(e.count for e in kernels)} kernels in {host_ms:.3f} ms of host time (the "
        f"device busy {device_ms / host_ms:.1%} of it, profiler on){shares}")


def _check_text_launches(label, prefill, run, n_layers) -> None:
    """K1 once per layer in the prefill, never in a decode step, and no
    other kernel."""
    want = {name: 0 for name in KERNEL_NAMES}
    want["flash_attention"] = n_layers
    if prefill != want or run != want:
        raise RuntimeError(f"{label}: launched {run} ({prefill} in the prefill), not {want}")


def text_pi0(device) -> dict:
    """Pi-0's text mode at the full bridge.yaml width, bf16, with
    joint.config.use_flash_attn set and random weights drawn on the card:
    the prefill (K1 at [B,8,276,256] over the [B,1,296,256] cache, 18
    launches) and 19 decode steps (one query row: the plain attention), at
    batch 1 and at batch 2 with a right-padded row. The K1 route against the
    plain one on the same weights (TEXT_REL_TOL), tokens compared for
    information; the padded row against that row alone, in bf16 for
    information and in fp32 (the same weights), where its teacher-forced
    logits must agree (TEXT_FP32_TOL) and its tokens be the same. Returns
    the launches of every run."""
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.presets import apply_preset, load_config

    label, smi = "text-pi0", card()
    cfg = load_config("config/eval/bridge.yaml")
    apply_preset(cfg, "blurr")
    cfg["joint"]["config"]["use_flash_attn"] = True
    t0 = time.monotonic()
    model = PiZero(cfg, device=device, dtype=torch.bfloat16)
    model.init_params(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    log(f"{label}: bridge.yaml, {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"params bf16 drawn on the card in {time.monotonic() - t0:.2f} s")
    s, n_layers = model.spec, cfg["joint"]["config"]["num_hidden_layers"]
    q_len, n_img = cfg["max_seq_len"], cfg["vision"]["config"]["num_image_tokens"]
    size = cfg["vision"]["config"]["image_size"]
    ids = torch.from_numpy(_text_prompt(2, q_len, n_img, s.image_token_index, 0)).to(device)
    am = torch.ones(2, q_len, dtype=torch.int32, device=device)
    am[1, q_len - TEXT_PAD:] = 0
    ids[1, q_len - TEXT_PAD:] = s.pad_token_id
    g = torch.Generator(device=device).manual_seed(1)
    px = torch.rand(2, 3, size, size, generator=g, device=device) * 2 - 1
    totals = {name: 0 for name in KERNEL_NAMES}

    def run(*args, **kwargs):
        out = _pi0_text_run(model, *args, **kwargs)
        _check_text_launches(label, out[1], out[2], n_layers)
        for name in KERNEL_NAMES:
            totals[name] += out[2][name]
        return out

    one = (ids[:1], px[:1].bfloat16())
    run(*one)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    prefills, steps = [], []
    for _ in range(3):
        toks, _, _, t_prefill, t_steps = run(*one, timed=True)
        prefills.append(t_prefill)
        steps += t_steps
    per_token = float(np.median(steps))
    log(f"{label}: batch 1, prompt {q_len}, {TEXT_NEW_TOKENS} tokens: prefill "
        f"{_median_ms(prefills)}; decode per token {_median_ms(steps)}; "
        f"{1000.0 / per_token:.1f} tokens/s in decode; peak memory "
        f"{torch.cuda.max_memory_allocated()} B (host clock, synchronized; on {smi})")
    log(f"{label}: batch 1 tokens {toks[0].tolist()}")
    prompt = model.infer_text_prefill(*one, q_len + TEXT_NEW_TOKENS)
    _profile_text(label, "one prefill at batch 1",
                  lambda: model.infer_text_prefill(*one, q_len + TEXT_NEW_TOKENS))
    _profile_text(label, "one decode step at batch 1", lambda: model.infer_text_decode_step(
        prompt[0][:, -1].argmax(-1), prompt[1], q_len))

    # the K1 route against the plain attention, the same weights; decode
    # teacher-forced on the K1 route's tokens
    forced = torch.from_numpy(toks).to(device)
    flash_spec = model.joint_spec
    logits = {}
    try:
        for route, spec in (("kernel", flash_spec),
                            ("plain", dataclasses.replace(flash_spec, use_flash_attn=False))):
            model.joint_spec = spec
            logits[route] = _pi0_forced_logits(model, *one, forced)
    finally:
        model.joint_spec = flash_spec
    top = logits["kernel"].abs().max().item()
    errs = (logits["kernel"] - logits["plain"]).abs().amax(-1)[0]
    agree = (logits["kernel"].argmax(-1) == logits["plain"].argmax(-1)).float().mean().item()
    log(f"{label}: K1 route vs plain attention, bf16, the same weights: prefill last logits "
        f"max_abs_diff={errs[0].item():.3e}, teacher-forced decode logits "
        f"max_abs_diff={errs[1:].max().item():.3e}, largest |logit| {top:.3f} (tol "
        f"{TEXT_REL_TOL:g} of it, {TEXT_REL_TOL * top:.3e}); greedy tokens agree at "
        f"{agree:.3f} of {TEXT_NEW_TOKENS} positions (information: random weights tie)")
    if not (torch.isfinite(logits["kernel"]).all() and errs.max().item() <= TEXT_REL_TOL * top):
        raise RuntimeError(f"{label}: the K1 and plain routes disagree: {errs.max().item()}")

    # batch 2, row 1 right-padded, against row 1 alone, the decode
    # teacher-forced on the batch's tokens: bf16 for information, then fp32
    # on the same weights, where the logits must agree within TEXT_FP32_TOL
    # of the largest |logit| and the tokens must be equal (bf16's roundings
    # differ between the two batch shapes)
    for dtype in (torch.bfloat16, torch.float32):
        if dtype == torch.float32:
            model.float()
        batch, _, _, t_prefill, t_steps = run(ids, px.to(dtype), am, timed=True)
        n_valid = q_len - TEXT_PAD
        alone, *_ = run(ids[1:2, :n_valid], px[1:2].to(dtype))
        same = (batch[1] == alone[0]).mean()
        forced = torch.from_numpy(batch).to(device)
        padded = _pi0_forced_logits(model, ids, px.to(dtype), forced, am)[1]
        single = _pi0_forced_logits(model, ids[1:2, :n_valid], px[1:2].to(dtype),
                                    forced[1:2])[0]
        top, diff = single.abs().max().item(), (padded - single).abs().max().item()
        gated = dtype == torch.float32
        log(f"{label}: batch 2 {str(dtype)[6:]}, row 1 padded by {TEXT_PAD}: prefill "
            f"{t_prefill:.3f} ms, decode per token {_median_ms(t_steps)} (host clock, on "
            f"{smi}); row 1's tokens equal to that row alone at {same:.3f} of "
            f"{TEXT_NEW_TOKENS}; its prefill and teacher-forced decode logits against that "
            f"row alone max_abs_diff={diff:.3e}, largest |logit| {top:.3f}, {diff / top:.3e} "
            f"of it" + (f" (tol {TEXT_FP32_TOL:g} of it)" if gated else " (information)"))
        if not (np.isfinite(batch).all() and torch.isfinite(padded).all()):
            raise RuntimeError(f"{label}: the padded batch is not finite")
        if gated and not (same == 1.0 and diff <= TEXT_FP32_TOL * top):
            raise RuntimeError(f"{label}: the padded row differs from that row alone: "
                               f"tokens {same}, logits {diff}")
    log(f"{label}: kernel launches over its {totals['flash_attention'] // n_layers} runs "
        f"{totals}: each prefill launched flash_attention {n_layers} times, no decode "
        f"step launched a kernel")
    del model
    torch.cuda.empty_cache()
    return totals


def _forced_logits(model, prompt, tokens) -> torch.Tensor:
    """A standalone model's ``prompt`` (its prefill's logits, cache and
    length) and its decode logits teacher-forced on ``tokens`` [B, T]:
    fp32 [B, T, V]."""
    out, cache, n = prompt
    outs = [out]
    for i in range(tokens.shape[1] - 1):
        out, cache, n = model.decode_logits(tokens[:, i], cache, n)
        outs.append(out)
    return torch.cat(outs, 1).float()


def text_paligemma(device) -> dict:
    """PaliGemma-3B at google/paligemma-3b-pt-224's widths, bf16 random
    weights drawn on the card, written as two safetensors shards under HF
    keys with a config.json, loaded by load_hf_model into a fresh model:
    the same bits, tokens and teacher-forced logits. generate against
    generate_fused (equal tokens), and generate_fused's device part under
    set_sync_debug_mode("warn"), which must find no synchronizing call and
    end on generate's teacher-forced logits; GemmaForCausalLM on the same
    weights, the same tokens and logits as PaliGemma's stack. Plain attention, no clamp, as in
    JAX: K1 must not launch. Returns the launches of the runs."""
    import shutil
    import warnings

    from torch.nn import functional as F

    from blurr_tpu_torch.models.paligemma.config import PaliGemmaConfig
    from blurr_tpu_torch.models.paligemma.load import load_hf_model
    from blurr_tpu_torch.models.paligemma.model import (
        GemmaForCausalLM,
        PaliGemmaForConditionalGeneration,
    )
    from blurr_tpu_torch.models.pi0.checkpoint import paligemma_state_dict, save_safetensors

    label, smi = "text-paligemma", card()
    config = PaliGemmaConfig(**PALIGEMMA_3B)
    t0 = time.monotonic()
    drawn = PaliGemmaForConditionalGeneration(config, device=device, dtype=torch.bfloat16)
    drawn.init_params(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    log(f"{label}: google/paligemma-3b-pt-224 widths, "
        f"{sum(p.numel() for p in drawn.parameters()) / 1e9:.3f} B params bf16 drawn on the "
        f"card in {time.monotonic() - t0:.2f} s")
    q_len = 264
    ids = torch.from_numpy(_text_prompt(1, q_len, 256, config.image_token_index, 2)).to(device)
    g = torch.Generator(device=device).manual_seed(3)
    px = (torch.rand(1, 3, 224, 224, generator=g, device=device) * 2 - 1).bfloat16()
    # timed before the files are written: the write's disk traffic would
    # share the host with the eager dispatch
    torch.cuda.reset_peak_memory_stats()
    prefills, steps, fused_ms = [], [], []
    for _ in range(5):
        t0 = time.monotonic()
        logits, cache, n = drawn.prefill(ids, px, q_len + TEXT_NEW_TOKENS)
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        prefills.append((time.monotonic() - t0) * 1000.0)
        for _ in range(TEXT_NEW_TOKENS - 1):
            t0 = time.monotonic()
            tok, cache, n = drawn.decode_step(tok, cache, n)
            torch.cuda.synchronize()
            steps.append((time.monotonic() - t0) * 1000.0)
        t0 = time.monotonic()
        drawn.generate_fused(ids, px, TEXT_NEW_TOKENS)
        fused_ms.append((time.monotonic() - t0) * 1000.0)
    per_token = float(np.median(steps))
    log(f"{label}: batch 1, prompt {q_len}, {TEXT_NEW_TOKENS} tokens: prefill "
        f"{_median_ms(prefills)}; decode per token {_median_ms(steps)}, "
        f"{1000.0 / per_token:.1f} tokens/s; generate_fused {_median_ms(fused_ms)}; peak "
        f"memory {torch.cuda.max_memory_allocated()} B (host clock, synchronized; on {smi})")
    _profile_text(label, "one prefill", lambda: drawn.prefill(ids, px, q_len + TEXT_NEW_TOKENS))
    _profile_text(label, "one decode step", lambda: drawn.decode_step(tok, cache, q_len))
    tmp = tempfile.mkdtemp(prefix="blurr_paligemma_")
    try:
        state = paligemma_state_dict(drawn.embed_tokens, drawn.vision_tower,
                                     drawn.multi_modal_projector, drawn.vlm)
        keys = list(state)
        shards = [k for k in keys if not k.startswith("language_model.model.layers.")], \
            [k for k in keys if k.startswith("language_model.model.layers.")]
        t0 = time.monotonic()
        for i, part in enumerate(shards):
            save_safetensors({k: state[k] for k in part},
                             os.path.join(tmp, f"model-0000{i + 1}-of-00002.safetensors"))
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(PALIGEMMA_3B, f)
        t_write = time.monotonic() - t0
        del state
        n_bytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        verify_checkpoint(label, ["--checkpoint", tmp, "--kind", "paligemma"])
        t0 = time.monotonic()
        model = load_hf_model(tmp, torch.bfloat16, device)
        torch.cuda.synchronize()
        t_load = time.monotonic() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"{label}: wrote {n_bytes} B ({n_bytes / 1e9:.3f} GB) as 2 safetensors shards and "
        f"config.json in {t_write:.2f} s; load_hf_model loaded them onto the card in "
        f"{t_load:.2f} s (host clock, on {smi}); files deleted")
    pairs = list(zip(drawn.named_parameters(), model.parameters()))
    if len(pairs) != len(list(drawn.parameters())) or not all(
            torch.equal(p, q) for (_, p), q in pairs):
        raise RuntimeError(f"{label}: the loaded weights differ from the written ones")
    _zero_counts()
    want = drawn.generate(ids, px, TEXT_NEW_TOKENS)
    host = model.generate(ids, px, TEXT_NEW_TOKENS)
    fused = model.generate_fused(ids, px, TEXT_NEW_TOKENS)
    launches = _counts()
    # random weights repeat one token, so the tokens say little: the logits
    # are compared too, bit for bit (the same operations on the same
    # inputs), teacher-forced on the tokens
    forced = torch.from_numpy(host).to(device)
    drawn_logits = _forced_logits(drawn, drawn.prefill(ids, px, q_len + TEXT_NEW_TOKENS), forced)
    loaded_logits = _forced_logits(model, model.prefill(ids, px, q_len + TEXT_NEW_TOKENS),
                                   forced)
    log(f"{label}: tokens {host[0].tolist()}; the loaded model's equal the drawn one's "
        f"{np.array_equal(host, want)}, its prefill and teacher-forced decode logits "
        f"max_abs_diff={(loaded_logits - drawn_logits).abs().max().item():.3e} (gated: the "
        f"same bits); generate_fused equal to generate {np.array_equal(fused, host)}; kernel "
        f"launches {launches} (K1 none: plain attention)")
    if not (np.array_equal(host, want) and np.array_equal(fused, host)
            and torch.equal(loaded_logits, drawn_logits)):
        raise RuntimeError(f"{label}: the loaded model or generate_fused differs")
    if any(launches.values()):
        raise RuntimeError(f"{label}: a kernel launched: {launches}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.monotonic()
            pending, last = model.fused_tokens(ids, px, TEXT_NEW_TOKENS)
            t_dispatch = time.monotonic() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    t0 = time.monotonic()
    same = np.array_equal(pending.cpu().numpy(), fused)
    t_wait = time.monotonic() - t0
    syncs = [str(w.message).splitlines()[0] for w in caught
             if not str(w.message).startswith("Synchronization debug mode is a prototype")]
    last_diff = (last.float() - loaded_logits[:, -1]).abs().max().item()
    log(f"{label}: generate_fused before its final copy under set_sync_debug_mode('warn'): "
        f"{len(syncs)} synchronizing operations {syncs[:3]}; dispatched in "
        f"{t_dispatch * 1000:.3f} ms, the copy then waited {t_wait * 1000:.3f} ms (host "
        f"clock, on {smi}); the same tokens {same}; its last step's logits against "
        f"generate's teacher-forced max_abs_diff={last_diff:.3e} (gated: the same bits)")
    if syncs or not same or not torch.equal(last.float(), loaded_logits[:, -1]):
        raise RuntimeError(f"{label}: generate_fused synchronizes or differs")
    del drawn
    gemma = GemmaForCausalLM(config, device=device, dtype=torch.bfloat16)
    with torch.no_grad():
        gemma.embed_tokens.copy_(model.embed_tokens)
    gemma.vlm.load_state_dict(model.vlm.state_dict())
    text = ids[:, 256:]
    t0 = time.monotonic()
    toks = gemma.generate(text, TEXT_NEW_TOKENS)
    t_gemma = (time.monotonic() - t0) * 1000.0
    prompt = model._prefill(F.embedding(text, model.embed_tokens),
                            text.shape[1] + TEXT_NEW_TOKENS)
    ref = model._greedy(*prompt, TEXT_NEW_TOKENS, None)
    forced = torch.from_numpy(ref).to(device)
    stack_logits = _forced_logits(model, model._prefill(
        F.embedding(text, model.embed_tokens), text.shape[1] + TEXT_NEW_TOKENS), forced)
    gemma_logits = _forced_logits(gemma, gemma.prefill(text, text.shape[1] + TEXT_NEW_TOKENS),
                                  forced)
    log(f"{label}: GemmaForCausalLM on the same weights, a {text.shape[1]}-token text prompt: "
        f"{TEXT_NEW_TOKENS} tokens in {t_gemma:.3f} ms (host clock, on {smi}); equal to "
        f"PaliGemma's stack on the same embeddings {np.array_equal(toks, ref)}, its prefill "
        f"and teacher-forced decode logits max_abs_diff="
        f"{(gemma_logits - stack_logits).abs().max().item():.3e} (gated: the same bits)")
    if not (np.array_equal(toks, ref) and torch.equal(gemma_logits, stack_logits)):
        raise RuntimeError(f"{label}: GemmaForCausalLM differs from PaliGemma's stack")
    del model, gemma
    torch.cuda.empty_cache()
    return launches


def small_text_vs_cpu(device) -> dict:
    """A small Pi-0 text model (bridge_tiny widths, fp32, use_flash_attn,
    an 80-token prompt so the prefill takes K1, row 1 right-padded) and a
    small PaliGemma (fp32, plain attention), each on the card against the
    same weights on the CPU: the tokens equal, the logits within SMALL_TOL.
    Returns the card's launches."""
    import copy as copy_lib

    from blurr_tpu_torch.models.paligemma.config import PaliGemmaConfig
    from blurr_tpu_torch.models.paligemma.model import PaliGemmaForConditionalGeneration
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.presets import apply_preset, load_config

    label = "small-text"
    cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(cfg, "prefix_cache")  # fp32
    cfg["joint"]["config"]["use_flash_attn"] = True
    cpu = PiZero(cfg, device="cpu", dtype=torch.float32)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = copy_lib.deepcopy(cpu).to(device)
    s, size = cpu.spec, cfg["vision"]["config"]["image_size"]
    n_img = cfg["vision"]["config"]["num_image_tokens"]
    ids = _text_prompt(2, 80, n_img, s.image_token_index, 4) % s.vocab_size
    ids[:, :n_img] = s.image_token_index
    ids[1, -7:] = s.pad_token_id
    am = np.ones((2, 80), np.int32)
    am[1, -7:] = 0
    px = np.random.RandomState(5).uniform(-1, 1, (2, 3, size, size)).astype(np.float32)
    inputs = [torch.from_numpy(ids), torch.from_numpy(px), torch.from_numpy(am)]

    def logits_and_tokens(model, ids, px, am):
        out, cache, n = model.infer_text_prefill(ids, px, 80 + 10, am)
        logits, toks = [out], [out[:, -1].argmax(-1)]
        for _ in range(9):
            out, cache, n = model.text_decode_logits(toks[-1], cache, n, am)
            logits.append(out)
            toks.append(out[:, -1].argmax(-1))
        return torch.cat(logits, 1).cpu(), torch.stack(toks, 1).cpu()

    ref = logits_and_tokens(cpu, *inputs)
    _zero_counts()
    out = logits_and_tokens(gpu, *(t.to(device) for t in inputs))
    torch.cuda.synchronize()
    launches = _counts()
    err = (out[0] - ref[0]).abs().max().item()
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    log(f"{label}: Pi-0 text, bridge_tiny widths, fp32, prompt 80 (row 1 padded by 7), 10 "
        f"tokens, card vs CPU: logits max_abs_err={err:.3e} (tol {SMALL_TOL:g}), tokens equal "
        f"{torch.equal(out[1], ref[1])}; kernel launches {launches} (expected {n_layers} of "
        f"flash_attention)")
    if not (err <= SMALL_TOL and torch.equal(out[1], ref[1])):
        raise RuntimeError(f"{label}: the card's Pi-0 text differs from the CPU's: {err}")
    if launches != {**{name: 0 for name in KERNEL_NAMES}, "flash_attention": n_layers}:
        raise RuntimeError(f"{label}: launched {launches}")
    config = PaliGemmaConfig(**SMALL_PALIGEMMA)
    cpu = PaliGemmaForConditionalGeneration(config, device="cpu")
    cpu.init_params(torch.Generator().manual_seed(1))
    gpu = copy_lib.deepcopy(cpu).to(device)
    n_img = config.vision_config.num_image_tokens
    ids = _text_prompt(2, n_img + 12, n_img, config.image_token_index, 6) % 998
    ids[:, :n_img] = config.image_token_index
    px = np.random.RandomState(7).uniform(-1, 1, (2, 3, 56, 56)).astype(np.float32)
    ref = cpu.prefill(torch.from_numpy(ids), torch.from_numpy(px), ids.shape[1] + 10)[0]
    out = gpu.prefill(torch.from_numpy(ids).to(device), torch.from_numpy(px).to(device),
                      ids.shape[1] + 10)[0].cpu()
    err = (out - ref).abs().max().item()
    toks_cpu = cpu.generate_fused(ids, px, 10)
    _zero_counts()
    toks_gpu = gpu.generate_fused(ids, px, 10)
    launches_pg = _counts()
    log(f"{label}: PaliGemma, fp32, prompt {ids.shape[1]}, 10 tokens, card vs CPU: prefill "
        f"logits max_abs_err={err:.3e} (tol {SMALL_TOL:g}), generate_fused tokens equal "
        f"{np.array_equal(toks_gpu, toks_cpu)}; kernel launches {launches_pg}")
    if not (err <= SMALL_TOL and np.array_equal(toks_gpu, toks_cpu)):
        raise RuntimeError(f"{label}: the card's PaliGemma differs from the CPU's: {err}")
    if any(launches_pg.values()):
        raise RuntimeError(f"{label}: PaliGemma launched {launches_pg}")
    return launches


# ---------------------------------------------------------------------------
# The OpenVLA family (phases 24-30)
# ---------------------------------------------------------------------------

# (M, K, N_pad, G) of K2 on the OpenVLA family's w4a8 path: OpenVLA-7B's
# q/k/v/o (N 4096 -> 4224), gate/up (11008 -> 11264), down (K 11008, G 43 of
# 256 rows) and head (32064 -> 32384) at the decode's M 1 and the prefill's
# M 288 (1 BOS + 256 patches + 31 text tokens); the Jacobi sweep's M 6 (its
# head at M 6 too: every tail position is verified); OFT's
# one forward at M 346 (288 + proprio + the empty token + 56 placeholders: a
# partial fourth block of 96 rows); MiniVLA's (Qwen2.5-0.5B) at M 1 and at
# its prefill's M 288 (256 patches + 32 text tokens): q/o and k/v at BN 128
# (K 896, G 7 of 128 rows, two groups to a 256-row chunk), gate/up at BN
# 256, down (K 4864, G 19) and the tied head. The served phases record every
# shape the w4a8 linears give K2, and any not listed here is held too.
OPENVLA_INT4_SHAPES = [
    (1, 4096, 4224, 8), (1, 4096, 11264, 8), (1, 11008, 4224, 43), (1, 4096, 32384, 8),
    (288, 4096, 4224, 8), (288, 4096, 11264, 8), (288, 11008, 4224, 43),
    (288, 4096, 32384, 8),
    (6, 4096, 4224, 8), (6, 4096, 11264, 8), (6, 11008, 4224, 43), (6, 4096, 32384, 8),
    (346, 4096, 4224, 8), (346, 4096, 11264, 8), (346, 11008, 4224, 43),
    (1, 896, 896, 7), (1, 896, 128, 7), (1, 896, 4864, 7), (1, 4864, 896, 19),
    (1, 896, 32384, 7),
    (288, 896, 896, 7), (288, 896, 128, 7), (288, 896, 4864, 7), (288, 4864, 896, 19),
]
# requests at 224x224 (cut from 5); then one off-size 256x320 frame
OPENVLA_FRAMES = 2  # 224x224 frames a served OpenVLA phase answers (cut from 5, then 3)
OPENVLA_INSTRUCTION = "put the spoon on the towel"
# serve-batched-openvla: prompts of 4 token counts in one bucket
OPENVLA_BATCH_INSTRUCTIONS = ("put the spoon on the towel", "pick up the carrot",
                              "move the small red block to the left of the bowl",
                              "open the drawer")
OPENVLA_BATCH_REQUESTS = 2  # per client
# K2 launches per request, counted from the code: 7 tokens x (32 layers x 7
# products + the quantized head); OFT's one forward has no head; MiniVLA's
# 24 layers and its tied head quantized
OPENVLA_FORWARD_LAUNCHES = 32 * 7 + 1
OPENVLA_AR_LAUNCHES = 7 * OPENVLA_FORWARD_LAUNCHES  # 1575
OPENVLA_OFT_LAUNCHES = 32 * 7  # 224
MINIVLA_AR_LAUNCHES = 7 * (24 * 7 + 1)  # 1183
# Jacobi's tokens against AR's, bf16 on the card: at the first position
# where they differ, the AR step's top-2 logit margin must be within this
# share of its largest |logit| (4 bf16 roundings of it): a multi-token
# forward may then round its way to the other token. Beyond the first
# difference the two chains condition on different tokens.
JACOBI_REL_MARGIN = 2.0**-6
# Jacobi's logits at the fixed point against the AR steps', as a share of
# the AR logits' largest |value|: up to the first token where the two
# differ, every position's logits must agree within it. In bf16 at w4a8
# (3.5 ulps of the largest logit), sound code read 0 in all but one of ~40
# frames over four H100 runs and one ulp (4.5e-3) in that one, the bits of a
# run's prefill differing between machines; but planted faults read the
# same one ulp there (tail positions one late, one early or from 0, a mask
# showing each row the next column or hiding the prompt): those random
# int8 weights leave the logits almost blind to positions. So the bf16
# bound only guards against gross numerics, and the fp32 bound below does
# the work: OpenVLA-7B at full width and depth in fp32, unquantized, where
# sound code read at most 9.6e-7 and the faults 4.5e-3 to 1.4.
JACOBI_LOGIT_REL_TOL = 2.0**-6
JACOBI_FP32_REL_TOL = 2.0**-14
# the faults planted in a copy of greedy_generate_jacobi (one line of its
# source replaced, the copy run in its module's namespace, the original
# put back): (what was planted, the line, its faulty form)
JACOBI_FAULTS = (
    ("tail positions one late", "tail_pos = n_valid[:, None] + tail[None, :]",
     "tail_pos = n_valid[:, None] + tail[None, :] + 1"),
    ("tail positions one early", "tail_pos = n_valid[:, None] + tail[None, :]",
     "tail_pos = n_valid[:, None] + tail[None, :] - 1"),
    ("tail positions from 0", "tail_pos = n_valid[:, None] + tail[None, :]",
     "tail_pos = tail[None, :].expand(b, t)"),
    ("the mask shows each row the next column", "(cols[None, None, :] <= (s + tail)[None, :, None])",
     "(cols[None, None, :] <= (s + tail + 1)[None, :, None])"),
    ("the mask hides the prompt", "& valid_cols).expand(b, t, max_len)",
     "& valid_cols & (cols >= s)[None, None, :]).expand(b, t, max_len)"),
)
# the shallow snapshot of phase 30: full widths, 2 LLaMA layers, 2 + 2 ViT
# blocks run (3 each stored in the spec, feature_layer -2)
SNAPSHOT_STATS = {"bridge_orig": {"action": {"q01": [-0.5] * 7, "q99": [0.5] * 7,
                                             "mask": [True] * 6 + [False]}}}


def _hold_int4(g, shape, bn, label, exact: bool = False) -> None:
    """K2 at (M, K, N_pad, G) and block width ``bn`` against its plain
    version, the same bits on a second call (within INT4_REL_TOL of the
    largest output, as int4_vs_plain; bit-equal with ``exact``), its grid
    and split of K logged, timed in a CUDA graph beside its bound and a bf16
    matmul of the dense weight."""
    from blurr_tpu_torch.ops.int4_matmul import grid, int4_matmul, int4_matmul_reference

    m, k, n, groups = shape
    x, packed, s, q = _int4_inputs(g, *shape, bn=bn)
    out = int4_matmul(x, packed, s)
    again = torch.equal(out, int4_matmul(x, packed, s))
    ref = int4_matmul_reference(x, packed, s)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = INT4_REL_TOL * ref.abs().max().item()
    blocks = grid(m, k, n, groups)
    graph = _graph_ms(lambda: int4_matmul(x, packed, s))
    least = _bound((x, packed, s), (out,), 2 * m * k * n, "int8")
    xb, wb = x.bfloat16(), q.bfloat16()
    dense = _graph_ms(lambda: torch.matmul(xb, wb))
    log(f"{label}: int4_matmul (M, K, N, G)={shape} BN {packed.shape[2]} "
        f"max_abs_err={err:.3e} bit-equal={torch.equal(out, ref)} (bound {tol:.3e}), "
        f"same bits on a second call {again}; S={blocks[1]} slices of K, grid {blocks}; "
        f"graph_ms {graph:.5f}, bound {least['bound_ms']:.5f} ms ({least['bound_by']}), "
        f"bf16 matmul of the dense weight graph_ms {dense:.5f}; on {card()}")
    if not (torch.isfinite(out).all() and err <= tol and again
            and (torch.equal(out, ref) or not exact)):
        raise RuntimeError(f"{label}: K2 disagrees with its plain version at {shape}")


def int4_openvla_vs_plain(device) -> set:
    """K2 at every listed OpenVLA-family shape (``_hold_int4``), at the
    block width pick_block_layout gives it. Returns the (M, K, N_pad, G,
    BN) held."""
    from blurr_tpu_torch.ops.int4_matmul import pick_block_layout

    g = torch.Generator(device=device).manual_seed(2)
    held = set()
    for shape in OPENVLA_INT4_SHAPES:
        bn = pick_block_layout(shape[2])[0]
        _hold_int4(g, shape, bn, "kernel-openvla")
        held.add((*shape, bn))
    torch.cuda.empty_cache()
    return held


class _RecordInt4Shapes:
    """While entered, the (M, K, N_pad, G, BN) of every call the w4a8
    linears make to K2 (``quant.int4_matmul`` wrapped; the wrapper under it
    still counts its launches)."""

    def __init__(self):
        self.seen = set()

    def __enter__(self):
        from blurr_tpu_torch.ops import quant

        self.inner = inner = quant.int4_matmul

        def recording(x, packed, scale):
            self.seen.add((x.shape[0], x.shape[1], scale.shape[1], scale.shape[0],
                           packed.shape[2]))
            return inner(x, packed, scale)

        quant.int4_matmul = recording
        return self

    def __exit__(self, *exc):
        from blurr_tpu_torch.ops import quant

        quant.int4_matmul = self.inner


class _RecordInt8Shapes:
    """While entered, the (M, K, N) of every call the int8 linears make to
    K3 (``quant.int8_mm_nd`` wrapped; the wrapper under it still counts its
    launches)."""

    def __init__(self):
        self.seen = set()

    def __enter__(self):
        from blurr_tpu_torch.ops import quant

        self.inner = inner = quant.int8_mm_nd

        def recording(x, w):
            self.seen.add((x.numel() // x.shape[-1], x.shape[-1], w["q"].shape[1]))
            return inner(x, w)

        quant.int8_mm_nd = recording
        return self

    def __exit__(self, *exc):
        from blurr_tpu_torch.ops import quant

        quant.int8_mm_nd = self.inner


def served_int4_vs_plain(device, seen: set, held: set, label: str = "served-int4-shapes",
                         what: str = "the OpenVLA phases", by: str = "kernel-openvla",
                         exact: bool = False) -> None:
    """Every shape served phases gave K2 held against its plain version
    (bit-equal with ``exact``): those an earlier phase (``by``) did not
    hold are held here."""
    g = torch.Generator(device=device).manual_seed(3)
    missing = sorted(seen - held)
    log(f"{label}: {what} gave K2 {len(seen)} shapes (M, K, N_pad, G, BN) {sorted(seen)}; "
        f"{len(missing)} not held by {by}{f': {missing}' if missing else ''}")
    for *shape, bn in missing:
        _hold_int4(g, tuple(shape), bn, label, exact)
    torch.cuda.empty_cache()


def _openvla_frames(n: int = OPENVLA_FRAMES):
    """``n`` 224x224 frames, then one 256x320, drawn from one seed: the
    first frames are the same whatever ``n``."""
    rng = np.random.RandomState(0)
    return ([rng.randint(0, 256, (224, 224, 3), np.uint8) for _ in range(n)]
            + [rng.randint(0, 256, (256, 320, 3), np.uint8)])


def _openvla_server(label, model_id, device, **kw):
    from blurr_tpu_torch.serving.openvla_server import OpenVLAActionServer

    t0 = time.monotonic()
    server = OpenVLAActionServer(model_id, device=device, **kw)
    torch.cuda.synchronize()
    model = server.model
    log(f"{label}: {model_id} {kw}, {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"fp parameters, built on the card in {time.monotonic() - t0:.2f} s; "
        f"resident parameters and buffers {resident_bytes(model)} B (LLM "
        f"{resident_bytes(model.llama)} B), allocated {torch.cuda.memory_allocated()} B")
    return server


def _serve_openvla(server, label, int4_per_request: int, proprio=None):
    """The frames through the port's ActionClient with the counts set to 0
    just before (after a warmup): each answer finite, [action_dim] in
    [-1, 1] (OFT: a [chunk_len, action_dim] chunk), K2 launched exactly
    ``int4_per_request`` times a request and no other kernel. Returns the
    counts and the answers."""
    from blurr_tpu_torch.serving.client import ActionClient

    frames = _openvla_frames()
    thread = _start(server)
    try:
        log(f"{label}: warmup {server.warmup():.2f} s")
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        latencies, answers = [], []
        with ActionClient(port=server.port) as client:
            for frame in frames:
                t = time.monotonic()
                answers.append(client.predict(frame, OPENVLA_INSTRUCTION,
                                              proprio if proprio is not None else [0.0] * 7))
                latencies.append((time.monotonic() - t) * 1000.0)
            stats = client.stats()
        launches = _counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        _stop(server, thread)
    want = (server.model.chunk_len, 7) if server.oft else (7,)
    for a in answers:
        if a.shape != want or not np.isfinite(a).all() or (
                not server.oft and np.abs(a).max() > 1.0):
            raise RuntimeError(f"{label}: bad answer {a.shape}: {a}")
    if stats["requests_total"] != len(frames):
        raise RuntimeError(f"{label}: {stats['requests_total']} requests served")
    log(f"{label}: {len(frames)} requests ({OPENVLA_FRAMES} at 224x224, one 256x320), latency "
        f"ms per request (client) {[round(x, 3) for x in latencies]}, median "
        f"{float(np.median(latencies)):.3f} ms, server p50 {stats.get('latency_ms_p50')} ms, "
        f"peak memory {peak} B (host clock, on {card()})")
    log(f"{label}: first answer {np.round(answers[0], 4).tolist()}")
    expected = int4_per_request * len(frames)
    log(f"{label}: int4_matmul launches {launches['int4_matmul']} (expected {expected} = "
        f"{int4_per_request} per request x {len(frames)})")
    if launches != {**{name: 0 for name in KERNEL_NAMES}, "int4_matmul": expected}:
        raise RuntimeError(f"{label}: launched {launches}")
    return launches, answers


def served_openvla_7b(device) -> dict:
    """OpenVLA-7B in bf16 at full width: no kernel of the port on its path
    (the ViTs and LLaMA attend in plain PyTorch, as JAX does in XLA)."""
    label = "serve-openvla-7b"
    server = _openvla_server(label, "random-7b", device)
    launches, _ = _serve_openvla(server, label, 0)
    frame = _openvla_frames()[0]
    _step_median(server, frame, None, label)
    _step_device_time(server, frame, None, label, "int4_matmul", top=16)
    del server
    _free()
    return launches


def _first_logits(server, frame) -> torch.Tensor:
    """The logits of the first action token for ``frame`` (fp32 [V])."""
    from blurr_tpu_torch.models.openvla.llama import greedy_generate

    ids, am, px = server._prepare(frame, OPENVLA_INSTRUCTION)
    _, logits = greedy_generate(server.model.llama, *server.model._inputs(ids, px, am), 1,
                                return_logits=True)
    return logits[0, 0].float()


def _k2_vs_plain(label, what, fn) -> None:
    """``fn()`` (a tensor) through K2 against the same call with every w4a8
    product on int4_matmul_reference (the launches are not counted): both
    sum exact group dots in group order, so any difference is a finding,
    bounded by INT4_REL_TOL of the largest |value|."""
    from blurr_tpu_torch.ops import int4_matmul as int4_mod
    from blurr_tpu_torch.ops import quant

    kernel = fn().float()
    inner = quant.int4_matmul
    quant.int4_matmul = int4_mod.int4_matmul_reference
    try:
        plain = fn().float()
    finally:
        quant.int4_matmul = inner
    err = (kernel - plain).abs().max().item()
    bound = INT4_REL_TOL * plain.abs().max().item()
    log(f"{label}: {what} through K2 against every product on int4_matmul_reference: "
        f"max_abs_err={err:.3e} (bound {bound:.3e}), bit-equal {torch.equal(kernel, plain)}, "
        f"argmax {int(kernel.argmax())} vs {int(plain.argmax())}")
    if not (torch.isfinite(kernel).all() and err <= bound):
        raise RuntimeError(f"{label}: {what} through K2 differ from the plain route's: {err}")


def _openvla_k2_vs_plain(server, label) -> None:
    """The first action token's logits through K2 against the plain route."""
    frame = _openvla_frames()[0]
    _k2_vs_plain(label, "the first token's logits", lambda: _first_logits(server, frame))


def _jacobi_vs_ar(model, inputs, init_guess=None) -> dict:
    """One Jacobi decode of 7 tokens (its sweeps and launches counted from
    0) and the AR decode on the same inputs: the tokens, the first position
    where they differ (7 where none), and the largest |difference| of their
    logits up to that position (Jacobi's at the fixed point: the last
    sweep's) beside the AR logits' largest |value|, the difference's rms as
    a share of theirs, and the share of logits that differ at all."""
    from blurr_tpu_torch.models.openvla.llama import greedy_generate, greedy_generate_jacobi

    _zero_counts()
    jac, sweeps, jac_lg = greedy_generate_jacobi(model.llama, *inputs, 7, init_guess=init_guess,
                                                 return_iters=True, return_logits=True)
    counts = _counts()
    ar, ar_lg = greedy_generate(model.llama, *inputs, 7, return_logits=True)
    jt, at = jac[0].tolist(), ar[0].tolist()
    first = next((j for j in range(7) if jt[j] != at[j]), 7)
    upto = min(first + 1, 7)
    a, d = ar_lg[0, :upto].float(), jac_lg[0, :upto].float() - ar_lg[0, :upto].float()
    return {"jac": jt, "ar": at, "sweeps": sweeps, "counts": counts, "first": first,
            "logit_err": d.abs().max().item(), "scale": a.abs().max().item(),
            "rms": (d.square().mean().sqrt() / a.square().mean().sqrt()).item(),
            "frac": (d != 0).float().mean().item(),
            "ar_logits": ar_lg[0].float(), "ar_tokens": ar}


def _planted_jacobi_faults():
    """Yields the name of each JACOBI_FAULTS entry while the faulty copy of
    ``greedy_generate_jacobi`` stands in its module."""
    import inspect

    from blurr_tpu_torch.models.openvla import llama as llama_mod

    good = llama_mod.greedy_generate_jacobi
    src = inspect.getsource(good)
    for name, line, faulty in JACOBI_FAULTS:
        if line not in src:
            raise RuntimeError(f"planted fault {name!r}: {line!r} is not in the source")
        exec(compile(src.replace(line, faulty), llama_mod.__file__, "exec"), llama_mod.__dict__)
        try:
            yield name
        finally:
            llama_mod.greedy_generate_jacobi = good


def _fault_readings(label, model, inputs, bound=None) -> None:
    """Each planted fault's logits against AR's steps, logged; with
    ``bound``, each must read over it (the check catches it)."""
    for name in _planted_jacobi_faults():
        r = _jacobi_vs_ar(model, inputs)
        rel = r["logit_err"] / r["scale"]
        log(f"{label}: planted fault ({name}): logits against AR's steps {rel:.3e} of the "
            f"largest |logit| (rms {r['rms']:.3e}, {r['frac']:.3e} of them differ), "
            f"{r['sweeps']} sweeps, tokens equal to AR {r['first'] == 7}")
        if bound is not None and not rel > bound:
            raise RuntimeError(f"{label}: the planted fault ({name}) reads {rel}, within "
                               f"the bound {bound}")


def _check_jacobi(label, r, what, per_forward=OPENVLA_FORWARD_LAUNCHES,
                  rel_tol=JACOBI_LOGIT_REL_TOL) -> None:
    """K2 launched ``per_forward`` x (1 + sweeps) times; the logits within
    ``rel_tol`` up to the first difference; a difference only where the AR
    step's top-2 margin is within JACOBI_REL_MARGIN."""
    expected = per_forward * (1 + r["sweeps"])
    step = r["ar_logits"][min(r["first"], 6)]
    top = step.topk(2).values
    margin = (top[0] - top[1]).item()
    bound = JACOBI_REL_MARGIN * step.abs().max().item()
    logit_bound = rel_tol * r["scale"]
    first = r["first"]
    diff = first < 7
    log(f"{label}: jacobi {what}: {r['sweeps']} sweeps, int4_matmul launches "
        f"{r['counts']['int4_matmul']} (expected {expected}); tokens equal to AR {not diff}"
        f"{f' up to position {first}' if diff else ''}; "
        f"logits against AR's steps max_abs_err {r['logit_err']:.3e} (bound {logit_bound:.3e}, "
        f"{r['logit_err'] / r['scale']:.3e} of the largest |logit|; rms {r['rms']:.3e}, "
        f"{r['frac']:.3e} of them differ); AR top-2 margin "
        f"{margin:.4f} at step {min(first, 6)} (bound {bound:.4f} where they differ)")
    if r["counts"] != {**{n: 0 for n in KERNEL_NAMES}, "int4_matmul": expected}:
        raise RuntimeError(f"{label}: jacobi {what} launched {r['counts']}")
    if not r["logit_err"] <= logit_bound:
        raise RuntimeError(f"{label}: jacobi {what}: logits {r['logit_err']} from AR's "
                           f"steps, over {logit_bound}")
    if diff and not margin <= bound:
        raise RuntimeError(f"{label}: jacobi {what} differs from AR at {first} with a "
                           f"top-2 margin {margin} over {bound}")


def _openvla_jacobi(server, label) -> dict:
    """The same server with decode 'jacobi': each frame served (K2 exactly
    225 x (1 + sweeps) times), its tokens those of a direct Jacobi decode
    (``_jacobi_vs_ar``, checked by ``_check_jacobi``); then one frame from a
    guess away from the fixed point (every token the AR one + 1), so two
    sweeps or more run. The planted faults of JACOBI_FAULTS are read on the
    first frame and logged. Returns the served requests' counts."""
    server.decode = "jacobi"
    model = server.model
    total = {name: 0 for name in KERNEL_NAMES}
    for i, frame in enumerate(_openvla_frames()):
        _zero_counts()
        served = server.predict(frame, OPENVLA_INSTRUCTION, [0.0] * 7)
        counts = _counts()
        total = {name: total[name] + counts[name] for name in KERNEL_NAMES}
        ids, am, px = server._prepare(frame, OPENVLA_INSTRUCTION)
        r = _jacobi_vs_ar(model, model._inputs(ids, px, am))
        if counts != r["counts"]:
            raise RuntimeError(f"{label}: served jacobi launched {counts}, direct {r['counts']}")
        _check_jacobi(label, r, f"frame {i}")
        if not np.array_equal(served, server._post(np.asarray([r["jac"]]))[0]):
            raise RuntimeError(f"{label}: the served jacobi answer is not its tokens'")
    ids, am, px = server._prepare(_openvla_frames()[0], OPENVLA_INSTRUCTION)
    inputs = model._inputs(ids, px, am)
    _fault_readings(label, model, inputs)  # read, not checked: see JACOBI_LOGIT_REL_TOL
    ar = _jacobi_vs_ar(model, inputs)["ar_tokens"]
    r = _jacobi_vs_ar(model, inputs, init_guess=(ar + 1) % model.spec.llama.vocab_size)
    _check_jacobi(label, r, "from a guess away from the fixed point")
    if r["sweeps"] < 2:
        raise RuntimeError(f"{label}: a guess away from the fixed point took {r['sweeps']} sweep")
    server.decode = "ar"
    return total


def served_openvla_7b_w4a8(device) -> dict:
    """OpenVLA-7B w4a8 (drawn quantized on the card): every LLM product and
    the head through K2, AR and Jacobi."""
    from blurr_tpu_torch.ops.quant import W4A8Linear

    label = "serve-openvla-7b-w4a8"
    server = _openvla_server(label, "random-7b", device, quantization="w4a8")
    n_int4 = sum(isinstance(m, W4A8Linear) for m in server.model.llama.modules())
    if n_int4 != OPENVLA_FORWARD_LAUNCHES:
        raise RuntimeError(f"{label}: {n_int4} w4a8 linears, not {OPENVLA_FORWARD_LAUNCHES}")
    launches, answers = _serve_openvla(server, label, OPENVLA_AR_LAUNCHES)
    ONE_RANK[label] = (answers, resident_bytes(server.model))
    frame = _openvla_frames()[0]
    _step_median(server, frame, None, label)
    _step_device_time(server, frame, None, label, "int4_matmul", top=16)
    _openvla_k2_vs_plain(server, label)
    jacobi = _openvla_jacobi(server, label)
    del server
    _free()
    return {name: launches[name] + jacobi[name] for name in KERNEL_NAMES}


def jacobi_fp32(device) -> None:
    """OpenVLA-7B at full width and depth in fp32, unquantized (no kernel of
    the port): Jacobi's logits at the fixed point against the AR steps'
    within JACOBI_FP32_REL_TOL, on three frames from a cold start and from
    a guess away from the fixed point; each decode's tokens AR's, or apart
    only where AR's top-2 margin allows; and every planted fault of
    JACOBI_FAULTS reading over the bound on the first frame."""
    label = "jacobi-fp32"
    server = _openvla_server(label, "random-7b", device, use_bf16=False)
    model = server.model
    for i, frame in enumerate(_openvla_frames(3)[:3]):
        ids, am, px = server._prepare(frame, OPENVLA_INSTRUCTION)
        inputs = model._inputs(ids, px, am)
        r = _jacobi_vs_ar(model, inputs)
        _check_jacobi(label, r, f"frame {i}", 0, JACOBI_FP32_REL_TOL)
        away = (r["ar_tokens"] + 1) % model.spec.llama.vocab_size
        r = _jacobi_vs_ar(model, inputs, init_guess=away)
        _check_jacobi(label, r, f"frame {i} from a guess away", 0, JACOBI_FP32_REL_TOL)
        if r["sweeps"] < 2:
            raise RuntimeError(f"{label}: a guess away from the fixed point took {r['sweeps']} sweep")
        if i == 0:
            _fault_readings(label, model, inputs, JACOBI_FP32_REL_TOL)
    del server, model
    _free()


def served_openvla_7b_w8a8(device) -> dict:
    label = "serve-openvla-7b-w8a8"
    server = _openvla_server(label, "random-7b", device, quantization="w8a8")
    launches, _ = _serve_openvla(server, label, 0)
    frame = _openvla_frames()[0]
    _step_median(server, frame, None, label)
    _step_device_time(server, frame, None, label, "int4_matmul", top=16)
    del server
    _free()
    return launches


def served_openvla_oft(device) -> dict:
    """OpenVLA-OFT at 7B, w4a8, with proprio: [8, 7] chunks, 224 K2 launches
    a request (one forward at M 346, no head); a chunk through K2 against
    the plain route."""
    label = "serve-openvla-oft"
    server = _openvla_server(label, "random-7b", device, quantization="w4a8", oft=True,
                             use_proprio=True)
    proprio = np.random.RandomState(1).uniform(-1, 1, server.proprio_dim).tolist()
    launches, _ = _serve_openvla(server, label, OPENVLA_OFT_LAUNCHES, proprio)
    frame = _openvla_frames()[0]
    _step_median(server, frame, proprio, label)
    _step_device_time(server, frame, proprio, label, "int4_matmul")
    _k2_vs_plain(label, "the [8, 7] chunk", lambda: torch.from_numpy(
        server._step(*server._prepare(frame, OPENVLA_INSTRUCTION, proprio))))
    del server
    _free()
    return launches


def served_minivla(device) -> dict:
    """MiniVLA (SigLIP alone, Qwen2.5-0.5B) in bf16 and in w4a8, its tied
    head quantized: 1,183 K2 launches a request; the w4a8 first token's
    logits through K2 against the plain route."""
    total = {name: 0 for name in KERNEL_NAMES}
    for quant, per_request in ((None, 0), ("w4a8", MINIVLA_AR_LAUNCHES)):
        label = f"serve-minivla-{quant or 'bf16'}"
        server = _openvla_server(label, "random-minivla", device, quantization=quant)
        launches, _ = _serve_openvla(server, label, per_request)
        _step_device_time(server, _openvla_frames()[0], None, label, "int4_matmul")
        if quant:
            _openvla_k2_vs_plain(server, label)
        total = {name: total[name] + launches[name] for name in KERNEL_NAMES}
        del server
        _free()
    return total


def _shallow_openvla(device):
    """OpenVLA at OpenVLA-7B's widths and a shallow depth (2 LLM layers, 3
    of each tower), bf16 weights drawn on the card (generator seed 5)."""
    from blurr_tpu_torch.models.openvla.llama import LlamaSpec
    from blurr_tpu_torch.models.openvla.model import DINOV2_L, SIGLIP_SO400M, OpenVLA, OpenVLASpec

    spec = OpenVLASpec(llama=LlamaSpec(num_layers=2),
                       dinov2=dataclasses.replace(DINOV2_L, num_layers=3),
                       siglip=dataclasses.replace(SIGLIP_SO400M, num_layers=3))
    model = OpenVLA(spec, SNAPSHOT_STATS, device=device, dtype=torch.bfloat16)
    return model.init_params(torch.Generator(device=device).manual_seed(5))


def openvla_snapshot(device) -> dict:
    """An HF-keyed snapshot at OpenVLA-7B's widths and a shallow depth,
    written with blurr_spec.json and dataset_statistics.json, loaded by
    build_openvla from the directory and served with an unnorm_key: the
    same weights bit for bit, and answers bit-equal to those of the model
    built in memory."""
    from blurr_tpu_torch.models.openvla.checkpoint import save_openvla_snapshot

    label = "openvla-snapshot"
    model = _shallow_openvla(device)
    with tempfile.TemporaryDirectory(prefix="blurr_openvla_") as tmp:
        t0 = time.monotonic()
        save_openvla_snapshot(model, tmp, SNAPSHOT_STATS)
        t_write = time.monotonic() - t0
        size = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        t0 = time.monotonic()
        server = _openvla_server(label, tmp, device, unnorm_key="bridge_orig")
        t_load = time.monotonic() - t0
    loaded = dict(server.model.named_parameters())
    drawn = dict(model.named_parameters())
    same = loaded.keys() == drawn.keys() and all(torch.equal(loaded[k], drawn[k]) for k in drawn)
    log(f"{label}: {len(drawn)} tensors, {size} B written in {t_write:.2f} s, loaded and "
        f"served by build_openvla in {t_load:.2f} s; the same bits {same}")
    if not same:
        raise RuntimeError(f"{label}: the loaded weights differ from the drawn ones")
    launches, answers = _serve_openvla(server, label, 0)
    for frame, answer in zip(_openvla_frames(), answers):
        ids, am, px = server._prepare(frame, OPENVLA_INSTRUCTION)
        direct = model.predict_action_tokens_ragged(ids, px, am).cpu().numpy()
        want = model.unnormalize(model.detokenize_actions(direct), "bridge_orig")[0]
        if not np.array_equal(answer, want.astype(np.float32)):
            raise RuntimeError(f"{label}: served {answer}, the drawn model gives {want}")
    log(f"{label}: {len(answers)} answers (unnorm_key bridge_orig) bit-equal to the model "
        f"built in memory")
    del server, model
    _free()
    return launches


# ---------------------------------------------------------------------------
# The OpenVLA-family eval CLIs and the checkpoint checker
# ---------------------------------------------------------------------------

# the HF eval CLI's run: HF_EVAL_EPISODES episodes of 4 control steps on the
# fake env (cut from 2 for the time limit)
HF_EVAL_EPISODES = 1
HF_EVAL_ARGS = ["--task", EVAL_TASK, "--n-eval-episode", str(HF_EVAL_EPISODES), "--max-steps",
                "4", "--preset", "blurr"]
# 4 AR control steps an episode; OFT: one [8, 7] chunk an episode at --max-steps 8
HF_EVAL_CALLS = 4 * HF_EVAL_EPISODES
# summary.json's keys, as the JAX script writes them
HF_SUMMARY_KEYS = {
    "model_id", "preset", "quantization", "dtype", "torch_compile", "attn_implementation",
    "image_preproc", "center_crop", "center_crop_scale", "normalize_proprio",
    "use_oft_action_head", "use_oft_proprio", "seed", "initial_states", "max_steps",
    "num_steps_wait", "episodes_per_task", "per_task_success", "avg_success"}
PRISMATIC_SUMMARY_KEYS = {
    "checkpoint", "unnorm_key", "num_steps_wait", "dtype", "seed", "initial_states",
    "max_steps", "episodes_per_task", "per_task_success", "avg_success"}
# the streaming quantizer's peak above its start may exceed quantizing the
# largest weight (the head) alone by no more than this
STREAMING_PEAK_SLACK = 64 * 2**20
# the eval snapshot's statistics: config.json's norm_stats (bridge_orig) and
# dataset_statistics.json (bridge_dataset, with an 8D proprio block) so the
# injection and the proprio normalization run
EVAL_CONFIG_STATS = {"bridge_orig": {"action": {
    "q01": [-0.03, -0.04, -0.03, -0.1, -0.1, -0.2, 0.0],
    "q99": [0.03, 0.04, 0.03, 0.1, 0.1, 0.2, 1.0], "mask": [True] * 6 + [False]}}}
EVAL_DATASET_STATS = {"bridge_dataset": {
    "action": {"q01": [-1.0] * 7, "q99": [1.0] * 7, "mean": [0.0] * 7},
    "proprio": {"q01": [0.0, 0.0, 0.0, -3.0, -3.0, -3.0, 0.0, 0.0],
                "q99": [0.3, 0.3, 0.3, 3.0, 3.0, 3.0, 1.0, 1.0]}}}
PRISMATIC_STATS = {"minivla_bridge": {"action": {
    "q01": [-0.02] * 6 + [0.0], "q99": [0.02] * 6 + [1.0], "mask": [True] * 6 + [False]}}}


def _cli(name: str):
    """A CLI of scripts/ imported as a module (its main() runs in-process)."""
    import importlib

    scripts = str(REPO_ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


class _EvalRun:
    """An eval CLI's main() in-process with the counts set to 0 just before
    and read just after (``launches``); the fake env records every action
    it is given, and every predict_action call of the OpenVLA classes is
    recorded: the model, its inputs, output, host ms (it returns host
    numpy, so the time is synchronized) and its kernel launches."""

    def __init__(self):
        self.actions, self.calls = [], []

    def __call__(self, cli, argv) -> dict:
        from blurr_tpu_torch.agent import fake_env
        from blurr_tpu_torch.models.openvla.model import OpenVLA, OpenVLAOFT

        actions, calls = self.actions, self.calls

        class Recording(fake_env.FakeSimplerEnv):
            def step(self, action):
                actions.append(np.array(action, np.float64, copy=True))
                return super().step(action)

        def recording(real):
            def predict_action(model, input_ids, pixel_values, **kw):
                before = _counts()
                t0 = time.monotonic()
                out = real(model, input_ids, pixel_values, **kw)
                ms = (time.monotonic() - t0) * 1000.0
                after = _counts()
                calls.append({"model": model, "ids": input_ids, "px": pixel_values, "kw": kw,
                              "out": out, "ms": ms,
                              "launches": {n: after[n] - before[n] for n in after}})
                return out
            return predict_action

        saved = (fake_env.make_env, OpenVLA.predict_action, OpenVLAOFT.predict_action)
        fake_env.make_env = lambda task: Recording(task)
        OpenVLA.predict_action = recording(saved[1])
        OpenVLAOFT.predict_action = recording(saved[2])
        try:
            _zero_counts()
            cli.main(argv)
            return _counts()
        finally:
            fake_env.make_env, OpenVLA.predict_action, OpenVLAOFT.predict_action = saved


def _check_eval_run(label, run: _EvalRun, launches, calls: int, per_call: dict,
                    variant: str = "hf") -> None:
    """``calls`` control steps, each launching ``per_call`` (and no other
    kernel), the phase's counts their sum; every env action equal to
    bridge_action_to_simpler of predict_action recomputed on the same
    processed inputs (each row of a chunk, in order); the gripper in
    {-1, 1}; the steps' host-clock median."""
    from blurr_tpu_torch.agent.hf_vla_utils import bridge_action_to_simpler
    from blurr_tpu_torch.models.openvla.model import OpenVLA, OpenVLAOFT

    want = {name: per_call.get(name, 0) for name in KERNEL_NAMES}
    if len(run.calls) != calls or any(c["launches"] != want for c in run.calls):
        raise RuntimeError(f"{label}: {len(run.calls)} control steps launching "
                           f"{[c['launches'] for c in run.calls][:2]}, not {calls} x {want}")
    total = {name: calls * want[name] for name in KERNEL_NAMES}
    if launches != total:
        raise RuntimeError(f"{label}: the run launched {launches}, not {total}")
    expected = []
    for c in run.calls:
        model, key = c["model"], c["kw"].get("unnorm_key")
        real = OpenVLAOFT.predict_action if isinstance(model, OpenVLAOFT) else OpenVLA.predict_action
        again = real(model, c["ids"], c["px"], **c["kw"])
        if not np.array_equal(again, c["out"]):
            raise RuntimeError(f"{label}: predict_action gave other bits on the same inputs")
        stats = model.norm_stats.get(key) or model.norm_stats.get("bridge_orig") or {}
        rows = np.asarray(again, np.float32).reshape(-1, 7)
        expected += [bridge_action_to_simpler(r, action_stats=stats.get("action") if key else None,
                                              variant=variant) for r in rows]
    if len(expected) != len(run.actions) or not all(
            np.array_equal(a, b.astype(np.float64)) for a, b in zip(run.actions, expected)):
        raise RuntimeError(f"{label}: {len(run.actions)} env actions against {len(expected)} "
                           f"recomputed; they differ")
    if not all(a[6] in (-1.0, 1.0) for a in run.actions):
        raise RuntimeError(f"{label}: a gripper value outside {{-1, 1}}")
    ms = [c["ms"] for c in run.calls]
    log(f"{label}: {calls} control steps, kernel launches {launches} ({want} each); every one "
        f"of {len(run.actions)} env actions equal to bridge_action_to_simpler(predict_action) "
        f"recomputed on the same processed inputs; predict_action ms per step {_median_ms(ms)}, "
        f"first {ms[0]:.1f} (host clock, synchronized; on {card()})")


def _check_summary_json(label, log_dir, keys) -> dict:
    summary = json.loads((Path(log_dir) / "summary.json").read_text())
    text = (Path(log_dir) / "run.log").read_text()
    if set(summary) != keys or "Success rate:" not in text:
        raise RuntimeError(f"{label}: summary.json keys {sorted(summary)} (want {sorted(keys)})"
                           f" or no 'Success rate:' in run.log")
    log(f"{label}: summary.json has the JAX script's {len(keys)} keys: "
        f"{json.dumps({k: summary[k] for k in sorted(summary) if k != 'per_task_success'})}")
    return summary


def _cli_subprocess(label, script: str, argv) -> None:
    """A CLI as a user runs it: exit 0 and 'Success rate:' in its run.log."""
    with tempfile.TemporaryDirectory(prefix="blurr_cli_") as tmp:
        cmd = [sys.executable, f"scripts/{script}", *argv, "--log-dir", tmp]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)
        secs = time.monotonic() - t0
        run_log = Path(tmp) / "run.log"
        text = run_log.read_text() if run_log.is_file() else ""
    log(f"{label}: {' '.join(cmd[1:-2])} as a subprocess -> exit {proc.returncode} in "
        f"{secs:.1f} s")
    if proc.returncode != 0 or "Success rate:" not in text:
        raise RuntimeError(f"{label}: the CLI failed:\n{proc.stderr[-3000:]}")
    for line in text.splitlines():
        if "Success rate" in line or "Avg success" in line:
            log(f"{label}: run.log: {line.split(' | ')[-1]}")


def eval_hf_7b_w4a8(device) -> dict:
    """scripts/eval_hf_vla_simpler_torch.py's main() in-process at
    OpenVLA-7B's widths, w4a8 drawn quantized on the card, HF_EVAL_EPISODES
    episodes of 4 steps: K2 1,575 times a control step, each env action the direct
    recomputation's, summary.json with JAX's keys; the step's median and one
    step's device time with K2's share; then the same command as a
    subprocess."""
    label = "eval-hf-7b-w4a8"
    argv = ["--model-id", "random-7b", "--quantization", "w4a8", *HF_EVAL_ARGS]
    run = _EvalRun()
    with tempfile.TemporaryDirectory(prefix="blurr_hf_eval_") as tmp:
        t0 = time.monotonic()
        launches = run(_cli("eval_hf_vla_simpler_torch"), [*argv, "--log-dir", tmp])
        log(f"{label}: main({' '.join(argv)}) in {time.monotonic() - t0:.1f} s")
        _check_summary_json(label, tmp, HF_SUMMARY_KEYS)
    _check_eval_run(label, run, launches, HF_EVAL_CALLS, {"int4_matmul": OPENVLA_AR_LAUNCHES})
    c = run.calls[0]
    _profile_text(label, "one control step (predict_action)",
                  lambda: c["model"].predict_action(c["ids"], c["px"], **c["kw"]), "int4_matmul")
    del run, c
    _free()
    _cli_subprocess(label, "eval_hf_vla_simpler_torch.py", argv)
    return launches


class _StreamingPeak:
    """While entered, each quantize_llama_streaming call's seconds and its
    peak allocated bytes above the bytes allocated at its start."""

    def __enter__(self):
        from blurr_tpu_torch.models.openvla import llama as llama_mod

        self.readings, self.real = [], llama_mod.quantize_llama_streaming

        def measured(llama, mode, *a, **kw):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            out = self.real(llama, mode, *a, **kw)
            torch.cuda.synchronize()
            self.readings.append((time.monotonic() - t0,
                                  torch.cuda.max_memory_allocated() - before, before))
            return out

        llama_mod.quantize_llama_streaming = measured
        return self

    def __exit__(self, *exc):
        from blurr_tpu_torch.models.openvla import llama as llama_mod

        llama_mod.quantize_llama_streaming = self.real


def _peak_above(fn) -> int:
    """Peak allocated bytes above the bytes allocated at the start of
    fn(), its result kept until it returns."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - before


def _quantize_alone_peak(lin) -> int:
    """Peak allocated bytes above the start for quantizing one weight alone
    (w4a8), its result kept as the quantizer keeps it."""
    from blurr_tpu_torch.ops.quant import W4A8Linear

    return _peak_above(lambda: W4A8Linear.from_linear(lin))


def verify_checkpoint(label: str, argv) -> None:
    """scripts/verify_checkpoint_torch.py's main() on a checkpoint this
    script wrote: it must report a clean match (exit 0)."""
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = _cli("verify_checkpoint_torch").main(list(argv))
    text = out.getvalue()
    lines = [line for line in text.splitlines() if line.strip()]
    log(f"verify-checkpoint: {label}: {' '.join(argv)} -> exit {rc} in "
        f"{time.monotonic() - t0:.2f} s: {' / '.join(lines[:1] + lines[-1:])}")
    if rc != 0 or "OK: checkpoint matches" not in text:
        raise RuntimeError(f"verify-checkpoint: {label}: not a clean match:\n{text[-3000:]}")


def eval_hf_snapshot(device) -> dict:
    """A full-depth OpenVLA-7B bf16 snapshot written by save_openvla_snapshot
    with config.json norm_stats (bridge_orig) and dataset_statistics.json
    (bridge_dataset): the checker reports a clean match; the eval CLI with
    --quantization w4a8 loads it and quantizes it by the streaming
    quantizer (its peak above its start within quantizing the head alone
    plus STREAMING_PEAK_SLACK; its bytes those of the drawn weights
    quantized layer by layer, that order's peak logged, then the head),
    infers bridge_orig and runs every action as recomputed. Then
    an OFT head (chunk 8) and an 8-wide proprio projector join the
    directory: OFT with proprio, 224 K2 launches a step, every action of
    each [8, 7] chunk executed."""
    import shutil

    from blurr_tpu_torch.models.openvla.checkpoint import (
        save_oft_aux_params,
        save_openvla_snapshot,
    )
    from blurr_tpu_torch.models.openvla.llama import quantize_llama_w4a8
    from blurr_tpu_torch.models.openvla.model import (
        RANDOM_SPECS,
        OFTActionHead,
        OFTProprioProjector,
        OpenVLA,
        init_dense,
    )
    from blurr_tpu_torch.ops.quant import quantize_mixture_w4a8

    label = "eval-hf-snapshot"
    spec = RANDOM_SPECS["random-7b"]()
    g = torch.Generator(device=device).manual_seed(11)
    drawn = OpenVLA(spec, device=device, dtype=torch.bfloat16).init_params(g)
    cli = _cli("eval_hf_vla_simpler_torch")
    tmp = tempfile.mkdtemp(prefix="blurr_hf_snapshot_")
    total = {name: 0 for name in KERNEL_NAMES}
    try:
        need = 2 * sum(p.numel() for p in drawn.parameters())
        log(f"{label}: {shutil.disk_usage(tmp).free} B free in {tmp} for {need} B of bf16 "
            f"weights and a 3.8 GB OFT head")
        t0 = time.monotonic()
        save_openvla_snapshot(drawn, tmp, EVAL_DATASET_STATS)
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"norm_stats": EVAL_CONFIG_STATS}, f)
        size = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        log(f"{label}: OpenVLA-7B ({spec.llama.num_layers} LLaMA layers) bf16 written as an HF "
            f"snapshot, {size} B in {time.monotonic() - t0:.1f} s")
        verify_checkpoint(label, ["--checkpoint", tmp, "--kind", "openvla"])
        alone = _quantize_alone_peak(drawn.llama.lm_head)
        for oft in (False, True):
            if oft:
                h = spec.llama.hidden_size
                head = OFTActionHead(8 * 7 * h, h, 8 * 7, 2, device=device, dtype=torch.bfloat16)
                proj = OFTProprioProjector(8, h, h, device=device, dtype=torch.bfloat16)
                init_dense(head, g)
                init_dense(proj, g)
                t0 = time.monotonic()
                save_oft_aux_params(tmp, head, proj, step=1000)
                log(f"{label}: OFT head (chunk 8) and proprio projector (8 inputs) written in "
                    f"{time.monotonic() - t0:.1f} s")
                del head, proj
            sub = f"{label}{'-oft' if oft else ''}"
            argv = ["--model-id", tmp, "--quantization", "w4a8", *HF_EVAL_ARGS]
            if oft:
                argv[argv.index("--max-steps") + 1] = "8"
            run = _EvalRun()
            with _StreamingPeak() as peak, tempfile.TemporaryDirectory() as logs:
                t0 = time.monotonic()
                launches = run(cli, [*argv, "--log-dir", logs])
                log(f"{sub}: main(--model-id <snapshot> ...) in {time.monotonic() - t0:.1f} s")
                _check_summary_json(sub, logs, HF_SUMMARY_KEYS)
            secs, above, before = peak.readings[0]
            log(f"{sub}: quantize_llama_streaming in {secs:.2f} s, peak {above} B above the "
                f"{before} B allocated at its start; quantizing the head alone {alone} B above "
                f"(bound {alone + STREAMING_PEAK_SLACK} B)")
            if len(peak.readings) != 1 or above > alone + STREAMING_PEAK_SLACK:
                raise RuntimeError(f"{sub}: the streaming peak {above} B is over the bound")
            keys = {c["kw"].get("unnorm_key") for c in run.calls}
            if keys != {"bridge_orig"}:
                raise RuntimeError(f"{sub}: unnorm keys {keys}, not bridge_orig")
            per = OPENVLA_OFT_LAUNCHES if oft else OPENVLA_AR_LAUNCHES
            _check_eval_run(sub, run, launches, HF_EVAL_EPISODES if oft else HF_EVAL_CALLS,
                            {"int4_matmul": per})
            if oft:
                c = run.calls[0]
                if c["out"].shape != (8, 7) or c["kw"]["proprio"].shape != (1, 8):
                    raise RuntimeError(f"{sub}: chunk {c['out'].shape}, proprio "
                                       f"{c['kw']['proprio'].shape}")
            else:
                loaded = run.calls[0]["model"].llama
                # the drawn weights layer by layer (each layer's q ... down),
                # the order before the kinds were sorted, then the head
                layer_order = _peak_above(lambda: quantize_mixture_w4a8(drawn.llama.layers))
                quantize_llama_w4a8(drawn.llama)
                log(f"{sub}: the layers quantized layer by layer instead: peak {layer_order} B "
                    f"above their start, against {above} B smallest kinds first")
                ours, theirs = dict(loaded.named_buffers()), dict(drawn.llama.named_buffers())
                same = ours.keys() == theirs.keys() and all(
                    torch.equal(ours[k], theirs[k]) for k in ours)
                fp_same = all(torch.equal(a, b) for a, b in zip(loaded.parameters(),
                                                               drawn.llama.parameters()))
                log(f"{sub}: the streamed model's {len(ours)} quantized buffers bit-equal to "
                    f"the drawn weights quantized layer by layer: {same}; fp tensors {fp_same}")
                if not (same and fp_same):
                    raise RuntimeError(f"{sub}: the streamed bytes differ")
                del drawn, loaded, ours, theirs
            total = {name: total[name] + launches[name] for name in KERNEL_NAMES}
            del run
            _free()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"{label}: files deleted")
    return total


def eval_prismatic(device) -> dict:
    """scripts/eval_prismatic_vla_simpler_torch.py's main() in-process at
    MiniVLA's widths and depth, bf16: --checkpoint random (HF_EVAL_EPISODES),
    then a prismatic .pt of weights drawn on the card (the CLI's
    prismatic_state_dict, bf16) in the run_dir/checkpoints/ layout beside a
    dataset_statistics.json: loaded bit-equal to the drawn weights with no
    "PARTIAL LOAD", the dataset's unnorm key, every env action the direct
    recomputation's, every gripper value in {-1, 1}. No kernel of the port
    runs (MiniVLA bf16 attends and multiplies in plain PyTorch)."""
    import shutil

    from blurr_tpu_torch.models.openvla.model import RANDOM_SPECS, OpenVLA

    label = "eval-prismatic"
    cli = _cli("eval_prismatic_vla_simpler_torch")
    argv = ["--task", EVAL_TASK, "--n-eval-episode", str(HF_EVAL_EPISODES), "--max-steps", "4"]
    total = {name: 0 for name in KERNEL_NAMES}
    with tempfile.TemporaryDirectory(prefix="blurr_prismatic_") as tmp:
        run = _EvalRun()
        launches = run(cli, ["--checkpoint", "random", *argv, "--log-dir", tmp + "/random"])
        _check_summary_json(f"{label}-random", tmp + "/random", PRISMATIC_SUMMARY_KEYS)
        _check_eval_run(f"{label}-random", run, launches, HF_EVAL_CALLS, {}, "prismatic")
        total = {name: total[name] + launches[name] for name in KERNEL_NAMES}
        del run
        _free()
        spec = RANDOM_SPECS["random-minivla"]()
        drawn = OpenVLA(spec, device=device, dtype=torch.bfloat16)
        drawn.init_params(torch.Generator(device=device).manual_seed(12))
        ckpt = Path(tmp) / "run_dir" / "checkpoints" / "step-001000.pt"
        ckpt.parent.mkdir(parents=True)
        (ckpt.parents[1] / "dataset_statistics.json").write_text(json.dumps(PRISMATIC_STATS))
        t0 = time.monotonic()
        torch.save({"model": {k: v.detach().cpu().contiguous()
                              for k, v in cli.prismatic_state_dict(drawn).items()}}, ckpt)
        log(f"{label}: MiniVLA bf16 written as a prismatic .pt, {ckpt.stat().st_size} B in "
            f"{time.monotonic() - t0:.1f} s")
        run = _EvalRun()
        launches = run(cli, ["--checkpoint", str(ckpt), *argv, "--log-dir", tmp + "/pt"])
        summary = _check_summary_json(label, tmp + "/pt", PRISMATIC_SUMMARY_KEYS)
        text = (Path(tmp) / "pt" / "run.log").read_text()
        _check_eval_run(label, run, launches, HF_EVAL_CALLS, {}, "prismatic")
        loaded = dict(run.calls[0]["model"].named_parameters())
        want = dict(drawn.named_parameters())
        same = loaded.keys() == want.keys() and all(torch.equal(loaded[k], want[k]) for k in want)
        log(f"{label}: {len(want)} tensors loaded bit-equal to the drawn ones: {same}; unnorm key "
            f"{summary['unnorm_key']}; 'PARTIAL LOAD' in run.log: {'PARTIAL LOAD' in text}")
        if not same or "PARTIAL LOAD" in text or summary["unnorm_key"] != "minivla_bridge":
            raise RuntimeError(f"{label}: the .pt did not load as written")
        total = {name: total[name] + launches[name] for name in KERNEL_NAMES}
        del run, drawn, loaded, want
        _free()
    return total


# ---------------------------------------------------------------------------
# Training (phases 36-40): scripts/train_pi0_flow_torch.py's main() in-process
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6
TRAIN_BATCH = 2
TRAIN_EXAMPLES = 16  # raw examples of the phase's sharded dataset (480x640 frames)
# K2 per training step of QLoRA w4a8, scope all: the vlm mixture's 7 linears
# in 17 layers and q, k, v in the last (122), the proprio mixture (the tied
# action module) the same (122), the action mixture's 7 in all 18 (126); the
# straight-through backward launches none. --remat runs the forward twice.
TRAIN_K2_PER_STEP = 370
TRAIN_ARGS = ["--config", "config/eval/bridge.yaml", "--lora-rank", "16",
              "--lora-quantize-base", "w4a8", "--dtype", "bf16", "--train-scope", "all",
              "--batch-size", str(TRAIN_BATCH), "--seed", "0", "--log-every", "1"]
# small-train: the bridge_tiny QLoRA w4a8 step, card against CPU (fp32, TF32
# off), the loss and each adapter gradient as a share of its largest |grad|:
# the two sides sum in other orders, and an fp32 activation within rounding
# of a half step of its per-token int8 quantization may round the other way
# on one side, moving that activation by 1/127 of its row's largest (as
# SMALL_W4A8_TOL; an H100 reads 2.0e-6 of the largest |grad|)
SMALL_TRAIN_TOL = 1e-3
# train-resume: the parameters of a run stopped at step 3 and resumed to 6
# against the uninterrupted run: bit-equal. No operation of the step sums
# with atomics (the frozen token embedding takes no gradient; cuBLAS and K2
# give the same bits on a second call), so none is needed
TRAIN_RESUME_TOL = 0.0


def _raw_shards(path: str, cfg, n: int = TRAIN_EXAMPLES, seed: int = 0) -> None:
    """A sharded dataset of raw robot examples: 480x640 uint8 frames (the
    transform resizes them with the Lanczos ladder), raw proprio and action
    chunks (normalized by config/bridge_statistics.json), pre-tokenized
    prompts of 8-12 text tokens after the image tokens."""
    from blurr_tpu_torch.data import write_dataset

    rng = np.random.RandomState(seed)
    n_img = cfg["vision"]["config"]["num_image_tokens"]
    seq = cfg["max_image_text_tokens"]
    ids = np.zeros((n, seq), np.int32)
    am = np.zeros((n, seq), np.int32)
    ids[:, :n_img] = cfg["image_token_index"]
    for i in range(n):
        k = 8 + i % 5
        ids[i, n_img:n_img + k] = rng.randint(3, 1000, k)
        am[i, :n_img + k] = 1
    write_dataset(path, {
        "image": rng.randint(0, 256, (n, 480, 640, 3), np.uint8),
        "proprio": rng.uniform(-0.2, 0.2, (n, cfg["proprio_dim"])).astype(np.float32),
        "action": rng.uniform(-0.02, 0.02, (n, cfg["horizon_steps"], cfg["action_dim"])
                              ).astype(np.float32),
        "input_ids": ids, "attention_mask": am,
    }, shard_size=8)


def _grads_of(model, trainable, kw, batch, *extra):
    """The loss and the gradients of ``trainable`` of one training step's
    inputs, as the step built with ``kw`` computes them (the batch cast to
    its dtype, its loss_fn on its batch_keys; Pi-0's extra are noise, t)."""
    from blurr_tpu_torch.parallel.train import _BATCH_KEYS, cast_batch, flow_loss, param_dtype

    b = cast_batch(batch, kw.get("compute_dtype") or param_dtype(model))
    keys = kw.get("batch_keys", _BATCH_KEYS)
    loss = kw.get("loss_fn", flow_loss)(model, *[b[k] for k in keys], *extra,
                                        remat=kw.get("remat", False))
    return [loss.detach()] + list(torch.autograd.grad(loss, trainable, allow_unused=True))


def _rel_reading(got, want) -> float:
    """max over the tensors of max|got - want| / max|want| (None: zeros)."""
    worst = 0.0
    for a, b in zip(got, want):
        if a is None and b is None:
            continue
        a = torch.zeros_like(b) if a is None else a
        b = torch.zeros_like(a) if b is None else b
        scale = b.float().abs().max().item()
        err = (a.float() - b.float().to(a.device)).abs().max().item()
        worst = max(worst, err / scale if scale > 0 else err)
    return worst


class _TrainRun:
    """A trainer's main(argv) in-process (train_pi0_flow_torch, or
    ``script``) with every optimizer step recorded: its kernel launches (the
    counts read just before and after the step alone), its host ms
    (synchronized) and its loss. ``first(model, trainable, kw, batch,
    *extra)`` runs before the first step, outside the counts; the step
    numbered ``profile_at`` runs under torch.profiler, and its ms stays out
    of the step median."""

    def __init__(self, device, first=None, profile_at=None, script="train_pi0_flow_torch"):
        self.device, self.steps, self.first, self.profile_at = device, [], first, profile_at
        self.prof, self.script = None, script

    def __call__(self, argv):
        from torch.profiler import ProfilerActivity, profile

        from blurr_tpu_torch.parallel import train as train_lib

        real = train_lib.make_train_step
        run = self

        def make(model, optimizer, **kw):
            step = real(model, optimizer, **kw)

            def recorded(batch, *extra):
                if not run.steps and run.first is not None:
                    run.first(model, optimizer.params, kw, batch, *extra)
                torch.cuda.synchronize()
                before, t0 = _counts(), time.monotonic()
                profiled = len(run.steps) == run.profile_at
                if profiled:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        loss = step(batch, *extra)
                        torch.cuda.synchronize()
                    run.prof = prof
                else:
                    loss = step(batch, *extra)
                torch.cuda.synchronize()
                ms = (time.monotonic() - t0) * 1000.0
                after = _counts()
                run.steps.append({"ms": ms, "loss": float(loss), "profiled": profiled,
                                  "launches": {n: after[n] - before[n] for n in after}})
                return loss

            recorded.accumulator = step.accumulator
            return recorded

        train_lib.make_train_step = make
        try:
            return _cli(self.script).main([*argv, "--device", str(self.device)])
        finally:
            train_lib.make_train_step = real

    def launches(self) -> dict:
        return {n: sum(s["launches"][n] for s in self.steps) for n in KERNEL_NAMES}

    def check(self, label, steps: int, per_step: dict) -> None:
        want = {n: per_step.get(n, 0) for n in KERNEL_NAMES}
        losses = [s["loss"] for s in self.steps]
        bad = [s["launches"] for s in self.steps if s["launches"] != want]
        if len(self.steps) != steps or bad or not np.isfinite(losses).all():
            raise RuntimeError(f"{label}: {len(self.steps)} steps (want {steps}), launches "
                               f"{bad[:1]} (want {want} each), losses {losses}")
        ms = [s["ms"] for s in self.steps]
        timed = [s["ms"] for s in self.steps[1:] if not s["profiled"]] or ms
        log(f"{label}: {steps} optimizer steps, each launching {want}; losses "
            f"{[round(x, 5) for x in losses]}; step ms {[round(x, 1) for x in ms]}; the steps "
            f"after the first, less the one under the profiler: {_median_ms(timed)} (host "
            f"clock, synchronized; on {card()})")


def _train_profile(label, prof) -> None:
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1000.0
    k2 = [e for e in kernels if "int4_matmul" in e.key]
    k2_ms = sum(e.self_device_time_total for e in k2) / 1000.0
    most = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"{label}: one optimizer step under torch.profiler: device time {total_ms:.3f} ms over "
        f"{sum(e.count for e in kernels)} kernels; K2 {k2_ms:.3f} ms over "
        f"{sum(e.count for e in k2)} launches ({100 * k2_ms / max(total_ms, 1e-9):.1f}%); the "
        f"longest: " + "; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                                 for e in most))
    if not total_ms > 0:
        raise RuntimeError(f"{label}: the profiler saw no device time")


def small_train_vs_cpu(device) -> None:
    """bridge_tiny, fp32, QLoRA w4a8 (scope all, rank 4, adapters' B drawn
    non-zero): one training step's loss and adapter gradients on the card
    (K2 in the forward) against the same step on the CPU (its plain
    version), the same weights, batch, noise and t."""
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.models.pi0.trainable import apply_mask
    from blurr_tpu_torch.ops.lora import LoRALinear, inject_lora_tree, lora_trainable_mask
    from blurr_tpu_torch.ops.quant import quantize_mixture_w4a8
    from blurr_tpu_torch.presets import load_config

    label = "small-train"
    cfg = load_config("config/eval/bridge_tiny.yaml")
    g = torch.Generator().manual_seed(0)
    cpu = PiZero(cfg, device="cpu", dtype=torch.float32).init_params(g)
    for m in ("vlm", "action"):
        quantize_mixture_w4a8(cpu.joint[m].layers)
    for mod in (cpu.vision_tower, cpu.joint["vlm"], cpu.joint["action"]):
        inject_lora_tree(mod, g, 4, ("q_w", "v_w"))
    with torch.no_grad():
        for mod in cpu.modules():
            if isinstance(mod, LoRALinear):
                mod.lora_b.normal_(0.0, 0.1, generator=g)
    gpu = copy.deepcopy(cpu).to(device)
    batch = _cli("train_pi0_flow_torch").synthetic_batch(cfg, 2, np.random.RandomState(0))
    rng = np.random.RandomState(1)
    noise = rng.randn(2, cfg["horizon_steps"], cfg["action_dim"]).astype(np.float32)
    t = (rng.rand(2) ** (2 / 3)).astype(np.float32)
    out = {}
    for name, model in (("cpu", cpu), ("card", gpu)):
        dev = next(model.parameters()).device
        trainable = apply_mask(model, lora_trainable_mask(model))
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _zero_counts()
        out[name] = _grads_of(model, trainable, {}, tb, torch.from_numpy(noise).to(dev),
                              torch.from_numpy(t).to(dev))
        out[name + "_k2"] = _counts()["int4_matmul"]
    loss_err = abs(out["card"][0].item() - out["cpu"][0].item()) / abs(out["cpu"][0].item())
    grad = _rel_reading([x.cpu() for x in out["card"][1:]], out["cpu"][1:])
    log(f"{label}: bridge_tiny QLoRA w4a8 step, card against CPU: loss {out['card'][0].item():.6f}"
        f" vs {out['cpu'][0].item():.6f} (rel {loss_err:.2e}), {len(out['cpu']) - 1} adapter "
        f"gradients within {grad:.3e} of each one's largest |grad| (tol {SMALL_TRAIN_TOL:g}); "
        f"K2 launched {out['card_k2']} times on the card")
    if not (loss_err <= SMALL_TRAIN_TOL and grad <= SMALL_TRAIN_TOL and out["card_k2"] > 0):
        raise RuntimeError(f"{label}: the card's training step disagrees with the CPU's")
    del cpu, gpu
    _free()


def train_qlora_w4a8(device, tmp: str, held: set):
    """train_pi0_flow_torch.py's main() at bridge.yaml's full width, random
    weights drawn on the card: QLoRA w4a8 rank 16, bf16, scope all, batch 2,
    TRAIN_STEPS steps from a sharded dataset of raw frames it writes. K2
    TRAIN_K2_PER_STEP times a step (and twice that with remat); the first
    step's loss and adapter gradients through K2 against every w4a8 product
    on int4_matmul_reference; the K2 shapes of the run held against the
    plain version; the int4 payloads and scales unchanged, lora_b non-zero,
    every loss finite; the step median, the peak memory, one step's device
    time and K2's share. Returns (launches, the run's result, the
    save-dir)."""
    from blurr_tpu_torch.ops import quant
    from blurr_tpu_torch.ops.int4_matmul import int4_matmul_reference
    from blurr_tpu_torch.ops.lora import LoRALinear
    from blurr_tpu_torch.presets import load_config

    label = "train-qlora-w4a8"
    cfg = load_config("config/eval/bridge.yaml")
    data = os.path.join(tmp, "shards")
    t0 = time.monotonic()
    _raw_shards(data, cfg)
    log(f"{label}: wrote a sharded dataset of {TRAIN_EXAMPLES} raw examples (480x640 uint8 "
        f"frames) in {time.monotonic() - t0:.2f} s")
    save_dir = os.path.join(tmp, "qlora")
    seen = {}

    def first(model, trainable, kw, batch, noise, t):
        seen["frozen"] = {n: b.clone() for n, b in model.named_buffers()
                          if n.endswith((".q4", ".s"))}
        seen["inputs"] = (batch, noise, t)
        kernel = _grads_of(model, trainable, kw, batch, noise, t)
        real = quant.int4_matmul
        quant.int4_matmul = int4_matmul_reference
        try:
            plain = _grads_of(model, trainable, kw, batch, noise, t)
        finally:
            quant.int4_matmul = real
        err = _rel_reading(kernel, plain)
        log(f"{label}: the first step through K2 against every w4a8 product on "
            f"int4_matmul_reference: loss {kernel[0].item():.6f} vs {plain[0].item():.6f}, "
            f"{len(trainable)} adapter gradients, largest error {err:.3e} of the largest |grad| "
            f"(tol {INT4_REL_TOL:g})")
        if err > INT4_REL_TOL:
            raise RuntimeError(f"{label}: K2's step disagrees with the plain route's")
        seen["trainable"] = trainable

    run = _TrainRun(device, first, profile_at=TRAIN_STEPS - 2)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with _RecordInt4Shapes() as rec:
        _zero_counts()
        result = run([*TRAIN_ARGS, "--data", data, "--steps", str(TRAIN_STEPS),
                      "--save-dir", save_dir])
    secs = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    run.check(label, TRAIN_STEPS, {"int4_matmul": TRAIN_K2_PER_STEP})
    model = result.model
    ONE_CARD[label] = {"losses": [st["loss"] for st in run.steps],
                       "param_bytes": sum(t.numel() * t.element_size()
                                          for t in (*model.parameters(), *model.buffers()))}
    log(f"{label}: main() in {secs:.1f} s; peak memory {peak} B ({peak / 2**30:.2f} GiB); "
        f"resident parameters and buffers {resident_bytes(model) / 1e9:.3f} GB; on {card()}")
    _train_profile(label, run.prof)
    now = dict(model.named_buffers())
    changed = [n for n, b in seen["frozen"].items() if not torch.equal(b, now[n])]
    # the vlm mixture's last-layer queries feed only vlm outputs that nothing
    # reads: that adapter's gradient is zero (in JAX too), so its B stays 0
    dead = f"joint.vlm.layers.{len(model.joint['vlm'].layers) - 1}.q_proj"
    lora_b = {n: m.lora_b for n, m in model.named_modules()
              if isinstance(m, LoRALinear) and n != dead}
    moved = sum(int(b.abs().max().item() > 0) for b in lora_b.values())
    log(f"{label}: {len(seen['frozen'])} int4 payloads and scales bit-unchanged: "
        f"{not changed}; {moved} of the {len(lora_b)} lora_b with a gradient path non-zero")
    if changed or moved != len(lora_b):
        raise RuntimeError(f"{label}: frozen buffers changed {changed[:3]} or lora_b zero")
    _zero_counts()
    batch, noise, t = seen["inputs"]
    _grads_of(model, seen["trainable"], {"remat": True}, batch, noise, t)
    remat = _counts()["int4_matmul"]
    log(f"{label}: one forward and backward with remat launched K2 {remat} times (want "
        f"{2 * TRAIN_K2_PER_STEP})")
    if remat != 2 * TRAIN_K2_PER_STEP:
        raise RuntimeError(f"{label}: remat launched K2 {remat} times")
    served_int4_vs_plain(device, rec.seen, held, label="train-int4-shapes",
                         what="the training run", by="the earlier kernel phases")
    return run.launches(), result, save_dir


def train_resume(device, tmp: str, uninterrupted) -> dict:
    """The same run with --save-every 2 --stop-after 3 into a manager root,
    then --resume-state from it to step TRAIN_STEPS: the parameters and
    buffers must equal the uninterrupted run's (phase train-qlora-w4a8)
    within TRAIN_RESUME_TOL. Returns the launches of both runs."""
    label = "train-resume"
    data, root = os.path.join(tmp, "shards"), os.path.join(tmp, "state")
    a, b = _TrainRun(device), _TrainRun(device)
    t0 = time.monotonic()
    a([*TRAIN_ARGS, "--data", data, "--steps", str(TRAIN_STEPS), "--save-state", root,
       "--save-every", "2", "--stop-after", "3"])
    a.check(label + " (stopped)", 3, {"int4_matmul": TRAIN_K2_PER_STEP})
    launches = a.launches()
    steps = sorted(e for e in os.listdir(root) if e.isdigit())
    size = sum(f.stat().st_size for f in Path(root, steps[-1]).iterdir())
    log(f"{label}: stopped after 3 steps in {time.monotonic() - t0:.1f} s; the manager root "
        f"holds steps {steps}, {size / 1e9:.3f} GB each")
    del a
    _free()
    t0 = time.monotonic()
    result = b([*TRAIN_ARGS, "--data", data, "--steps", str(TRAIN_STEPS), "--resume-state", root])
    b.check(label + " (resumed)", TRAIN_STEPS - 3, {"int4_matmul": TRAIN_K2_PER_STEP})
    mine = dict(result.model.state_dict())
    theirs = dict(uninterrupted.state_dict())
    errs = {k: (mine[k].float() - theirs[k].float()).abs().max().item() for k in theirs
            if mine[k].is_floating_point()}
    same = all(torch.equal(mine[k], theirs[k]) for k in theirs)
    worst = max(errs.values())
    log(f"{label}: resumed to step {TRAIN_STEPS} in {time.monotonic() - t0:.1f} s; its "
        f"{len(theirs)} parameters and buffers bit-equal to the uninterrupted run's: {same} "
        f"(largest difference {worst:.3e}, tol {TRAIN_RESUME_TOL:g})")
    if mine.keys() != theirs.keys() or worst > TRAIN_RESUME_TOL:
        raise RuntimeError(f"{label}: the resumed run ends elsewhere")
    del result, mine
    _free()
    return {n: launches[n] + b.launches()[n] for n in KERNEL_NAMES}


def train_serve(device, save_dir: str, model) -> dict:
    """The QLoRA --save-dir of train-qlora-w4a8 served by ActionServer
    (bridge.yaml, blurr preset): the adapters unmerged over the int4 bases,
    K2 TRAIN_K2_PER_STEP times a request (the bf16 step's int4 linears),
    answers finite and in range, and the served model's action chunk equal
    to the trained model's in memory on the same inputs and noise."""
    from blurr_tpu_torch.ops.lora import LoRALinear
    from blurr_tpu_torch.ops.quant import W4A8Linear
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.server import ActionServer

    label = "train-serve"
    cfg = load_config("config/eval/bridge.yaml")
    apply_preset(cfg, "blurr")
    t0 = time.monotonic()
    server = ActionServer(cfg, save_dir, device=device, seed=0)
    torch.cuda.synchronize()
    q = server.model.joint["vlm"].layers[0].q_proj
    log(f"{label}: ActionServer(bridge.yaml blurr, {os.path.basename(save_dir)}/) loaded in "
        f"{time.monotonic() - t0:.2f} s as {server.dtype}; vlm q_proj {type(q).__name__} over "
        f"{type(getattr(q, 'base', q)).__name__}")
    if not (isinstance(q, LoRALinear) and isinstance(q.base, W4A8Linear)):
        raise RuntimeError(f"{label}: the adapter tree was not rebuilt")
    per_step = launches_per_step(server.model, (W4A8Linear, LoRALinear))
    image, proprio, launches, actions = _serve_requests(server, cfg, label)
    _check_launches(label, launches, {"int4_matmul": TRAIN_K2_PER_STEP, "flash_attention": 0,
                                      "int8_matmul": 0})
    inputs = server._prepare(image, "put the spoon on the towel", proprio)
    noise = server.noise(0)
    steps = server.model.spec.num_inference_steps  # the preset's, not the training config's
    with torch.no_grad():
        served = server.model.infer_action(*inputs, noise, steps)
        memory = model.infer_action(*inputs, noise, steps)
    same = torch.equal(served, memory)
    log(f"{label}: {per_step} int4 linears a step; the served chunk equal to the trained model's "
        f"in memory on the same inputs and noise: {same}")
    if not same:
        raise RuntimeError(f"{label}: the served model answers other bits")
    del server
    _free()
    return launches


def train_full(device, tmp: str) -> dict:
    """Full fine-tuning at full width: --train-scope action_expert --dtype
    fp32, 3 steps (no kernel of the port runs), its peak memory; then a bf16
    LoRA run (no quantization) whose --save-dir is merged, exported by
    export_torch_checkpoint_torch.py to a reference .pt, and loaded by
    load_checkpoint: the same bits as the directory, whose weights are the
    trained model's merged in memory."""
    from blurr_tpu_torch.models.pi0.checkpoint import load_checkpoint, restore_params
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.ops.lora import merge_lora_tree
    from blurr_tpu_torch.presets import load_config

    label = "train-full"
    common = ["--config", "config/eval/bridge.yaml", "--batch-size", str(TRAIN_BATCH),
              "--seed", "0", "--log-every", "1"]
    run = _TrainRun(device)
    torch.cuda.reset_peak_memory_stats()
    result = run([*common, "--train-scope", "action_expert", "--dtype", "fp32", "--steps", "3"])
    run.check(label + " (action_expert fp32)", 3, {})
    n = sum(p.numel() for p in result.model.parameters() if p.requires_grad)
    log(f"{label}: action_expert fp32, {n} trainable parameters; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card()}")
    launches = run.launches()
    del result, run
    _free()
    save_dir, pt = os.path.join(tmp, "lora"), os.path.join(tmp, "lora.pt")
    run = _TrainRun(device)
    torch.cuda.reset_peak_memory_stats()
    result = run([*common, "--lora-rank", "16", "--dtype", "bf16", "--steps", "2",
                  "--save-dir", save_dir])
    run.check(label + " (LoRA bf16)", 2, {})
    log(f"{label}: LoRA bf16 peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = {n: launches[n] + run.launches()[n] for n in KERNEL_NAMES}
    cfg = load_config("config/eval/bridge.yaml")
    saved = restore_params(PiZero(cfg, device=device, dtype=torch.bfloat16), save_dir)
    in_memory = copy.deepcopy(result.model)
    merged = merge_lora_tree(in_memory)
    same_dir = all(torch.equal(a, b) for a, b in zip(saved.state_dict().values(),
                                                     in_memory.state_dict().values()))
    del result, run, in_memory
    _free()
    t0 = time.monotonic()
    _cli("export_torch_checkpoint_torch").main(["--config", "config/eval/bridge.yaml",
                                                "--params", save_dir, "--out", pt,
                                                "--device", str(device)])
    t_export = time.monotonic() - t0
    loaded = load_checkpoint(PiZero(cfg, device=device, dtype=torch.float32), pt)
    same_pt = all(torch.equal(a, b.float()) for a, b in zip(loaded.state_dict().values(),
                                                            saved.state_dict().values()))
    log(f"{label}: {merged} adapters merged; the save-dir equal to the in-memory merge: "
        f"{same_dir}; exported to a {os.path.getsize(pt) / 1e9:.2f} GB .pt in {t_export:.1f} s, "
        f"loaded by load_checkpoint bit-equal to the directory (fp32 of its bf16): {same_pt}")
    if not (same_dir and same_pt):
        raise RuntimeError(f"{label}: the merged directory or its .pt differs")
    os.remove(pt)
    del loaded, saved
    _free()
    return launches


# ---------------------------------------------------------------------------
# OpenVLA training (scripts/train_openvla_lora_torch.py)
# ---------------------------------------------------------------------------

VLA_TRAIN_STEPS = 6
VLA_OFT_STEPS = 3
VLA_TRAIN_EXAMPLES = 16  # the sharded dataset's examples (the trainer's synthetic frames)
# K2 per optimizer step of OpenVLA-7B QLoRA w4a8 at batch 2: the 7 products
# of each of the 32 layers at M = 2 x 295 embedded rows, and the head on the
# 2 x 7 label rows alone (AR); OFT runs no head. The straight-through
# backward launches none; remat recomputes the 224 layer products (the head
# is outside the checkpointed layers)
VLA_TRAIN_AR_K2 = 32 * 7 + 1  # 225
VLA_TRAIN_OFT_K2 = 32 * 7  # 224
VLA_TRAIN_ARGS = ["--model-id", "random-7b", "--quantize-base", "w4a8", "--lora-rank", "32",
                  "--dtype", "bf16", "--batch-size", "2", "--seed", "0", "--log-every", "1"]
VLA_INSTRUCTION = "put the spoon on the towel"
# peft-roundtrip: a bf16 LoRA run merged two ways, in memory (A @ B rounded
# to bf16, then W + s * delta rounded again) and through the PEFT directory
# (the fp32 factors' product added in fp32, rounded once to bf16): three
# bf16 roundings (half an ulp, 2^-9, each) of values up to each tensor's
# largest |value| apart, so the merged weights within PEFT_WEIGHT_REL_TOL
# (four such roundings) of it, and the first token's logits of the two
# merged LLMs, both run in fp32 so that only the weights differ, within
# PEFT_LOGIT_REL_TOL of the largest |logit|
PEFT_WEIGHT_REL_TOL = 2.0**-7
PEFT_LOGIT_REL_TOL = 2.0**-6
OPENLOOP_KEYS = {"examples", "variant", "mse", "mae", "gripper_agreement", "model_id",
                 "checkpoint", "quantization", "seed", "token_accuracy"}


def _vla_shards(path: str, oft: bool = False) -> None:
    """A sharded OpenVLA dataset (write_openvla_dataset) of the trainer's
    synthetic examples: 224x224 frames, four instructions, actions [7] (OFT:
    [8, 7] chunks and 8-dim proprio)."""
    from blurr_tpu_torch.models.openvla.data import write_openvla_dataset

    raw = _cli("train_openvla_lora_torch").synthetic_examples(
        VLA_TRAIN_EXAMPLES, 224, (8, 7) if oft else (7,), 0, proprio_dim=8 if oft else 0)
    write_openvla_dataset(path, raw["images"], raw["instructions"], raw["actions"],
                          proprios=raw.get("proprios"), shard_size=8)


def _vla_first_logits(model, frame) -> torch.Tensor:
    """The first action token's logits (fp32 [V]) for ``frame`` and
    VLA_INSTRUCTION, the prompt tokenized by the stub."""
    from blurr_tpu_torch.models.openvla.llama import greedy_generate
    from blurr_tpu_torch.models.openvla.processing import (
        StubLlamaTokenizer,
        process_image,
        tokenize_prompt_ids,
    )

    ids = torch.tensor([tokenize_prompt_ids(StubLlamaTokenizer(), VLA_INSTRUCTION)])
    px = process_image(frame, model.spec.siglip.image_size, model.spec.use_fused_vision)
    with torch.no_grad():
        _, logits = greedy_generate(model.llama, *model._inputs(ids, px), 1, return_logits=True)
    return logits[0, 0].float()


def train_openvla_qlora(device, tmp: str):
    """scripts/train_openvla_lora_torch.py's main() in-process at OpenVLA-7B's
    widths: random-7b drawn quantized w4a8 on the card (no bf16 7B), rank-32
    adapters on all seven projections, bf16, batch 2, the AR objective,
    VLA_TRAIN_STEPS steps from a sharded dataset the phase writes, and
    --save-params. K2 VLA_TRAIN_AR_K2 times a step (and 2 x 225 - 1 for one
    forward and backward with remat); the first step's loss and factor
    gradients through K2 against every w4a8 product on
    int4_matmul_reference; the int4 payloads and scales bit-unchanged, every
    lora_b non-zero, every loss finite; the step median, the peak memory,
    one step's device time and K2's share. Returns (launches, the run's
    result, the K2 shapes it gave, the --save-params directory, the
    dataset)."""
    from blurr_tpu_torch.ops import quant
    from blurr_tpu_torch.ops.int4_matmul import int4_matmul_reference
    from blurr_tpu_torch.ops.lora import LoRALinear

    label = "train-openvla-qlora-w4a8"
    data, params = os.path.join(tmp, "vla_shards"), os.path.join(tmp, "vla_params")
    t0 = time.monotonic()
    _vla_shards(data)
    log(f"{label}: wrote a sharded dataset of {VLA_TRAIN_EXAMPLES} examples (224x224 frames) in "
        f"{time.monotonic() - t0:.2f} s")
    seen = {}

    def first(model, trainable, kw, batch):
        seen["frozen"] = {n: b.clone() for n, b in model.named_buffers()
                          if n.endswith((".q4", ".s"))}
        seen.update(inputs=batch, kw=kw, trainable=trainable)
        kernel = _grads_of(model, trainable, kw, batch)
        real = quant.int4_matmul
        quant.int4_matmul = int4_matmul_reference
        try:
            plain = _grads_of(model, trainable, kw, batch)
        finally:
            quant.int4_matmul = real
        err = _rel_reading(kernel, plain)
        rows = model.spec.siglip.num_patches + batch["input_ids"].shape[1]
        log(f"{label}: {rows} embedded rows an example ({batch['input_ids'].shape[1]} ids); the "
            f"first step through K2 against every w4a8 product on int4_matmul_reference: loss "
            f"{kernel[0].item():.6f} vs {plain[0].item():.6f}, {len(trainable)} factors, largest "
            f"error {err:.3e} of the largest |grad| (tol {INT4_REL_TOL:g})")
        if err > INT4_REL_TOL:
            raise RuntimeError(f"{label}: K2's step disagrees with the plain route's")

    run = _TrainRun(device, first, profile_at=VLA_TRAIN_STEPS - 2,
                    script="train_openvla_lora_torch")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with _RecordInt4Shapes() as rec:
        _zero_counts()
        result = run([*VLA_TRAIN_ARGS, "--data", data, "--steps", str(VLA_TRAIN_STEPS),
                      "--save-params", params])
    secs = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    run.check(label, VLA_TRAIN_STEPS, {"int4_matmul": VLA_TRAIN_AR_K2})
    model = result.model
    size = sum(f.stat().st_size for f in Path(params).iterdir())
    log(f"{label}: main() in {secs:.1f} s (the draw, {VLA_TRAIN_STEPS} steps and a {size / 1e9:.3f} "
        f"GB --save-params); peak memory {peak} B ({peak / 2**30:.2f} GiB); resident parameters "
        f"and buffers {resident_bytes(model) / 1e9:.3f} GB; on {card()}")
    _train_profile(label, run.prof)
    now = dict(model.named_buffers())
    changed = [n for n, b in seen.pop("frozen").items() if not torch.equal(b, now[n])]
    lora_b = [m.lora_b for m in model.modules() if isinstance(m, LoRALinear)]
    moved = sum(int(b.abs().max().item() > 0) for b in lora_b)
    log(f"{label}: the int4 payloads and scales bit-unchanged: {not changed}; {moved} of the "
        f"{len(lora_b)} lora_b non-zero")
    if changed or moved != len(lora_b) or len(lora_b) != 32 * 7:
        raise RuntimeError(f"{label}: frozen buffers changed {changed[:3]} or lora_b zero")
    _zero_counts()
    _grads_of(model, seen["trainable"], {**seen["kw"], "remat": True}, seen["inputs"])
    remat = _counts()["int4_matmul"]
    log(f"{label}: one forward and backward with remat launched K2 {remat} times (want "
        f"{2 * VLA_TRAIN_AR_K2 - 1})")
    if remat != 2 * VLA_TRAIN_AR_K2 - 1:
        raise RuntimeError(f"{label}: remat launched K2 {remat} times")
    return run.launches(), result, rec.seen, params, data


def train_openvla_resume(device, tmp: str, data: str, uninterrupted) -> dict:
    """The same run with --save-state --stop-after 3, then --resume-state
    from it to VLA_TRAIN_STEPS: the parameters and buffers bit-equal to the
    uninterrupted run's. Returns the launches of both runs."""
    label = "train-openvla-resume"
    state = os.path.join(tmp, "vla_state")
    a, b = (_TrainRun(device, script="train_openvla_lora_torch") for _ in range(2))
    t0 = time.monotonic()
    a([*VLA_TRAIN_ARGS, "--data", data, "--steps", str(VLA_TRAIN_STEPS), "--save-state", state,
       "--stop-after", "3"])
    a.check(label + " (stopped)", 3, {"int4_matmul": VLA_TRAIN_AR_K2})
    launches = a.launches()
    size = sum(f.stat().st_size for f in Path(state).iterdir())
    log(f"{label}: stopped after 3 steps and wrote a {size / 1e9:.3f} GB training state in "
        f"{time.monotonic() - t0:.1f} s")
    del a
    _free()
    t0 = time.monotonic()
    result = b([*VLA_TRAIN_ARGS, "--data", data, "--steps", str(VLA_TRAIN_STEPS),
                "--resume-state", state])
    b.check(label + " (resumed)", VLA_TRAIN_STEPS - 3, {"int4_matmul": VLA_TRAIN_AR_K2})
    mine, theirs = result.model.state_dict(), uninterrupted.state_dict()
    same = mine.keys() == theirs.keys() and all(torch.equal(mine[k], theirs[k]) for k in theirs)
    log(f"{label}: resumed to step {VLA_TRAIN_STEPS} in {time.monotonic() - t0:.1f} s; its "
        f"{len(theirs)} parameters and buffers bit-equal to the uninterrupted run's: {same}")
    if not same:
        raise RuntimeError(f"{label}: the resumed run ends elsewhere")
    del result, mine
    _free()
    return {n: launches[n] + b.launches()[n] for n in KERNEL_NAMES}


def train_openvla_serve(device, params: str, model) -> dict:
    """The --save-params directory served by the OpenVLA server
    (checkpoint_path, no quantization): the adapters rebuilt over the int4
    bases, 1,575 K2 launches a request, every answer equal to the trained
    model's own on the same request; then hot-reloaded into the running
    server, and answered the same again."""
    from blurr_tpu_torch.ops.lora import LoRALinear
    from blurr_tpu_torch.ops.quant import W4A8Linear
    from blurr_tpu_torch.serving.client import ActionClient

    label = "train-openvla-serve"
    server = _openvla_server(label, "random-7b", device, checkpoint_path=params)
    q = server.model.llama.layers[0].q_proj
    if not (isinstance(q, LoRALinear) and isinstance(q.base, W4A8Linear)):
        raise RuntimeError(f"{label}: the adapter tree was not rebuilt: {type(q).__name__}")
    launches, answers = _serve_openvla(server, label, OPENVLA_AR_LAUNCHES)
    frames = _openvla_frames()
    for frame, answer in zip(frames, answers):
        ids, am, px = server._prepare(frame, OPENVLA_INSTRUCTION)
        want = model.detokenize_actions(model.predict_action_tokens_ragged(ids, px, am).cpu())
        if not np.array_equal(answer, want[0].astype(np.float32)):
            raise RuntimeError(f"{label}: served {answer}, the trained model gives {want}")
    log(f"{label}: {len(answers)} answers equal to the trained model's in memory")
    thread = _start(server)
    try:
        with ActionClient(port=server.port) as client:
            t0 = time.monotonic()
            client.reload(params)
            secs = time.monotonic() - t0
            _zero_counts()
            again = client.predict(frames[0], OPENVLA_INSTRUCTION, [0.0] * 7)
            reloaded = _counts()
            stats = client.stats()
    finally:
        _stop(server, thread)
    log(f"{label}: hot reload of {os.path.basename(params)}/ into the running server in "
        f"{secs:.2f} s; reloads_total {stats['reloads_total']}; the answer after it equal: "
        f"{np.array_equal(again, answers[0])}")
    if stats["reloads_total"] != 1 or not np.array_equal(again, answers[0]):
        raise RuntimeError(f"{label}: the reloaded server answers otherwise")
    del server
    _free()
    return {n: launches[n] + reloaded[n] for n in KERNEL_NAMES}


def train_openvla_oft(device, tmp: str):
    """OFT at 7B w4a8 with proprio: --oft --use-proprio, VLA_OFT_STEPS steps
    from a sharded dataset of [8, 7] chunks; K2 VLA_TRAIN_OFT_K2 times a
    step; the head and projector written by --save-adapter as the
    reference's .pt files and read back by load_oft_aux_params bit-equal.
    Returns (launches, the K2 shapes it gave)."""
    from blurr_tpu_torch.models.openvla.checkpoint import load_oft_aux_params

    label = "train-openvla-oft"
    data, out = os.path.join(tmp, "vla_oft_shards"), os.path.join(tmp, "vla_oft")
    _vla_shards(data, oft=True)
    run = _TrainRun(device, profile_at=1, script="train_openvla_lora_torch")
    torch.cuda.reset_peak_memory_stats()
    with _RecordInt4Shapes() as rec:
        _zero_counts()
        result = run([*VLA_TRAIN_ARGS, "--oft", "--use-proprio", "--data", data, "--steps",
                      str(VLA_OFT_STEPS), "--save-adapter", os.path.join(out, "lora_adapter")])
    run.check(label, VLA_OFT_STEPS, {"int4_matmul": VLA_TRAIN_OFT_K2})
    log(f"{label}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _train_profile(label, run.prof)
    head, proj = load_oft_aux_params(out, device, torch.bfloat16)
    same = all(torch.equal(a, b) for mine, theirs in ((result.model.action_head, head),
                                                      (result.model.proprio_projector, proj))
               for a, b in zip(mine.state_dict().values(), theirs.state_dict().values()))
    log(f"{label}: {sorted(f for f in os.listdir(out) if f.endswith('.pt'))} read back by "
        f"load_oft_aux_params bit-equal: {same}")
    if not same:
        raise RuntimeError(f"{label}: the OFT aux files read back otherwise")
    del result
    _free()
    return run.launches(), rec.seen


def peft_roundtrip(device, tmp: str) -> dict:
    """A bf16 LoRA run (rank 16, 2 steps) on a shallow snapshot
    (``_shallow_openvla``) writes --save-adapter into the snapshot's
    lora_adapter/; build_openvla(dir) merges it: the first token's logits
    within PEFT_LOGIT_REL_TOL of the trained model merged in memory
    (merge_lora_tree). A snapshot whose base already holds the delta loads
    with "already contain" logged and its weights unchanged."""
    import shutil

    from blurr_tpu_torch.models.openvla.build import build_openvla
    from blurr_tpu_torch.models.openvla.checkpoint import load_openvla_hf_dir, save_openvla_snapshot
    from blurr_tpu_torch.models.openvla.model import OpenVLA
    from blurr_tpu_torch.ops.lora import _delta, _read_peft, merge_lora_tree

    label = "peft-roundtrip"
    snap, merged_snap = os.path.join(tmp, "peft_snap"), os.path.join(tmp, "peft_merged")
    save_openvla_snapshot(_shallow_openvla(device), snap, SNAPSHOT_STATS)
    _free()
    run = _TrainRun(device, script="train_openvla_lora_torch")
    result = run(["--model-id", snap, "--lora-rank", "16", "--dtype", "bf16", "--batch-size", "2",
                  "--steps", "2", "--lr", "5e-3", "--seed", "0", "--log-every", "1",
                  "--save-adapter", os.path.join(snap, "lora_adapter")])
    run.check(label + " (bf16 LoRA)", 2, {})
    in_memory = copy.deepcopy(result.model)
    n = merge_lora_tree(in_memory)
    built, lines = _run_logged(lambda: build_openvla(snap, device=device, dtype=torch.bfloat16))
    merged = [line for line in lines if "Merged" in line]
    w_err = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                for a, b in zip(built.model.llama.parameters(), in_memory.llama.parameters()))
    frame = _openvla_frames()[0]
    want = _vla_first_logits(copy.deepcopy(in_memory).float(), frame)
    got = _vla_first_logits(copy.deepcopy(built.model).float(), frame)
    unmerged = OpenVLA(in_memory.spec, device=device, dtype=torch.float32)
    base = _vla_first_logits(load_openvla_hf_dir(unmerged, snap, lora=False), frame)
    err = ((got - want).abs().max() / want.abs().max()).item()
    moved = ((base - want).abs().max() / want.abs().max()).item()
    log(f"{label}: {n} adapters merged in memory; build_openvla logged {merged}; the LLM's "
        f"weights within {w_err:.3e} of each tensor's largest |value| (tol "
        f"{PEFT_WEIGHT_REL_TOL:g}); the first token's logits in fp32 within {err:.3e} of the "
        f"largest |logit| (tol {PEFT_LOGIT_REL_TOL:g}); the base without the adapter reads "
        f"{moved:.3e}")
    if not (merged and w_err <= PEFT_WEIGHT_REL_TOL and err <= PEFT_LOGIT_REL_TOL):
        raise RuntimeError(f"{label}: the merged snapshot differs from the in-memory merge")
    save_openvla_snapshot(in_memory, merged_snap, SNAPSHOT_STATS)
    shutil.copytree(os.path.join(snap, "lora_adapter"), os.path.join(merged_snap, "lora_adapter"))
    again, lines = _run_logged(lambda: build_openvla(merged_snap, device=device,
                                                     dtype=torch.bfloat16))
    skipped = any("already contain the LoRA adapter" in line for line in lines)
    same = all(torch.equal(a, b) for a, b in zip(again.model.state_dict().values(),
                                                 in_memory.state_dict().values()))
    scale, per = _read_peft(os.path.join(snap, "lora_adapter"))

    def coefficients(model):  # <W, d> / <d, d> of every factor
        out = []
        for proj, layers in per.items():
            for i, ab in layers.items():
                d = _delta(ab, scale).to(device)
                w = getattr(model.llama.layers[i], proj).weight.detach().T.float()
                out.append(float((w * d).sum() / (d * d).sum()))
        return out

    merged_c, unmerged_c = coefficients(again.model), coefficients(unmerged)
    log(f"{label}: a snapshot whose base holds the delta, with the same lora_adapter/: "
        f"'already merged' logged {skipped}, its weights unchanged {same}; projection "
        f"coefficients {min(merged_c):.4f}..{max(merged_c):.4f} (band 0.6..1.4; the unmerged "
        f"base's {min(unmerged_c):.4f}..{max(unmerged_c):.4f})")
    if not (skipped and same):
        raise RuntimeError(f"{label}: a merged base took the adapter again")
    del result, in_memory, built, again, unmerged
    _free()
    return run.launches()


def eval_openloop_vla(data: str, params: str) -> None:
    """scripts/eval_openloop_vla_torch.py as a user runs it, in a subprocess,
    on the --save-params directory over the dataset's last 16 examples:
    exit 0 and JAX's metric keys on its last line (its launches are another
    process's and do not count)."""
    label = "eval-openloop-vla"
    cmd = [sys.executable, "scripts/eval_openloop_vla_torch.py", "--model-id", "random-7b",
           "--checkpoint", params, "--data", data, "--examples", str(VLA_TRAIN_EXAMPLES)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)
    secs = time.monotonic() - t0
    lines = proc.stdout.strip().splitlines()
    log(f"{label}: {' '.join(cmd[1:])} -> exit {proc.returncode} in {secs:.1f} s; {lines[-1:]}")
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: the CLI failed:\n{proc.stderr[-3000:]}")
    metrics = json.loads(lines[-1])
    if set(metrics) != OPENLOOP_KEYS or metrics["examples"] != VLA_TRAIN_EXAMPLES:
        raise RuntimeError(f"{label}: metrics {metrics}")


# ---------------------------------------------------------------------------
# Pi-0's open-loop eval, the recorded dataset and GPTQ (phases 47-53)
# ---------------------------------------------------------------------------

OPENLOOP_BATCH = 8
# (label, config, extra flags, examples, launches per batch)
OPENLOOP_RUNS = (
    ("openloop-bf16", "config/eval/bridge.yaml", ["--use-bf16"], 20,
     {"flash_attention": 17}),
    ("openloop-pool64-w4a8", "config/eval/bridge_pool64_w4a8_steps1.yaml", ["--use-bf16"], 20,
     {"flash_attention": 17, "int4_matmul": W4A8_STEP_LAUNCHES}),
    ("openloop-fp32", "config/eval/bridge.yaml", [], 8, {"flash_attention": 17}),
)
OPENLOOP_METRICS = {"examples", "horizon", "act_steps", "mse", "mae", "mse_prefix", "eef_l2",
                    "gripper_agreement", "per_dim_mse", "config", "checkpoint", "seed"}
GPTQ_CONFIG = "config/eval/bridge_pool64_w4a8_steps1.yaml"
GPTQ_LAYERS = (0, 8, 17)  # the layers whose held-out output error is compared
CLOSED_LOOP_VARIANTS = ("pool64_bf16", "pool64_w4a8", "pool64_w4a8_gptq")
CLOSED_LOOP_EPISODES = 1


class _FlashConfigs:
    """While entered, every config ``blurr_tpu_torch.benchmarks.load_cfg``
    loads has ``joint.config.use_flash_attn`` set, as the served phases set
    it on theirs (the shipped YAMLs leave K1 off)."""

    def __enter__(self):
        from blurr_tpu_torch import benchmarks

        self.real = real = benchmarks.load_cfg

        def load_cfg(config):
            cfg = real(config)
            cfg["joint"]["config"]["use_flash_attn"] = True
            return cfg

        benchmarks.load_cfg = load_cfg
        return self

    def __exit__(self, *exc):
        from blurr_tpu_torch import benchmarks

        benchmarks.load_cfg = self.real


def _openloop(label, argv, examples: int, per_batch: dict) -> dict:
    """scripts/eval_openloop_torch.py in-process with K1 on, the counts set
    to 0 just before it: the metrics' keys, finite values and example count,
    and each kernel's launches per batch. Returns the launches."""
    _zero_counts()
    t0 = time.monotonic()
    with _FlashConfigs():
        metrics = _cli("eval_openloop_torch").main(argv)
    torch.cuda.synchronize()
    launches = _counts()
    batches = -(-examples // OPENLOOP_BATCH)
    log(f"{label}: eval_openloop_torch.py {' '.join(argv)} in {time.monotonic() - t0:.2f} s: "
        f"mse {metrics['mse']:.6f} mae {metrics['mae']:.6f} gripper_agreement "
        f"{metrics['gripper_agreement']:.4f} over {metrics['examples']} examples in {batches} "
        f"batches of {OPENLOOP_BATCH}; on {card()}")
    floats = [metrics[k] for k in ("mse", "mae", "mse_prefix", "eef_l2")] + metrics["per_dim_mse"]
    if (set(metrics) != OPENLOOP_METRICS or metrics["examples"] != examples
            or not np.isfinite(floats).all()):
        raise RuntimeError(f"{label}: metrics {metrics}")
    _check_eval_launches(label, launches, per_batch, batches)
    ONE_RANK[label] = metrics
    return launches


def openloop_runs(device) -> list:
    """Phase 49: the open-loop CLI at full width on synthetic data, bf16
    (bridge.yaml, 20 examples, the tail batch padded), pool64 w4a8 and fp32
    (K1 is held at their shapes by ``flash_shapes_vs_plain``)."""
    runs = []
    for label, config, extra, examples, per_batch in OPENLOOP_RUNS:
        argv = ["--config", config, "--checkpoint", "random", "--examples", str(examples),
                "--batch-size", str(OPENLOOP_BATCH), *extra]
        runs.append(_openloop(label, argv, examples, per_batch))
        _free()
    return runs


def flash_shapes_vs_plain(device, seen: dict) -> None:
    """K1 at every (shape, dtype) the open-loop, recording, GPTQ and
    closed-loop phases gave it, with the first mask it met there, held
    against its plain version (bf16 within BF16_TOL, fp32 within
    FP32_EXACT_TOL), then timed beside SDPA and its bound."""
    from blurr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    smi = card()
    log(f"openloop-flash: the phases gave K1 {len(seen)} (shape, dtype) pairs "
        f"{sorted((shape, str(dtype)[6:]) for shape, dtype in seen)}")
    for (shape, dtype), mask in sorted(seen.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_EXACT_TOL
        _hold_flash(shape, dtype, tol, "openloop-flash", device, mask=mask)
        q, k, v, mask = _attention_inputs(shape, device, mask=mask)
        qc, kc, vc = q.to(dtype), k.to(dtype), v.to(dtype)
        b, nh, _, sq, skv, d = shape
        t = _kernel_times(lambda: flash_attention(qc, kc, vc, mask),
                          lambda: flash_attention_reference(qc, kc, vc, mask),
                          lambda: torch.nn.functional.scaled_dot_product_attention(
                              qc, kc, vc, attn_mask=mask[:, None], enable_gqa=True))
        kind = "bf16" if dtype == torch.bfloat16 else "tf32x3"
        bound = _bound((qc, kc, vc, mask), (qc,), 4 * b * nh * sq * skv * d, kind)
        log(f"openloop-flash: time at {shape} {str(dtype)[6:]}: {_fmt_times(t)}; bound "
            f"{bound['bound_ms']:.5f} ms ({bound['bound_by']}, {kind}); on {smi}")
    torch.cuda.empty_cache()


class _RecordFlashShapes:
    """While entered, the (b, nh, kvh, sq, skv, d) and dtype of every call
    Pi-0's joint makes to K1, each with the first mask it came with
    (``joint.flash_attention`` wrapped; the wrapper under it still counts
    its launches)."""

    def __init__(self):
        self.seen = {}

    def __enter__(self):
        from blurr_tpu_torch.models.pi0 import joint

        self.inner = inner = joint.flash_attention

        def recording(q, k, v, mask=None, **kw):
            key = ((*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3]), q.dtype)
            if key not in self.seen:
                self.seen[key] = mask.clone()
            return inner(q, k, v, mask, **kw)

        joint.flash_attention = recording
        return self

    def __exit__(self, *exc):
        from blurr_tpu_torch.models.pi0 import joint

        joint.flash_attention = self.inner


def _check_recorded(label, agent, fetched: int) -> None:
    """The agent's --record-dataset directory: one example per fetched chunk,
    the four input keys and the actions at their shapes, finite."""
    from blurr_tpu_torch.data import ShardedDataset

    ds = ShardedDataset(agent.record_dir)
    s = agent.model.spec
    size = agent.cfg["vision"]["config"]["image_size"]
    want = {"input_ids": [s.max_image_text_tokens], "attention_mask": [s.max_image_text_tokens],
            "pixel_values": [3, size, size], "proprios": [s.num_proprio_tokens, s.proprio_dim],
            "actions": [s.num_action_tokens, s.action_dim]}
    shapes = {k: v["shape"] for k, v in ds.keys.items()}
    actions = ds.gather("actions", np.arange(ds.num_examples))
    log(f"{label}: --record-dataset wrote {ds.num_examples} examples ({fetched} chunks "
        f"fetched) to {sorted(p.name for p in Path(agent.record_dir).iterdir())}; keys {shapes}")
    if ds.num_examples != fetched or shapes != want or not np.isfinite(actions).all():
        raise RuntimeError(f"{label}: the recorded dataset is wrong: {ds.num_examples} "
                           f"examples, {shapes}")


def _recorded_examples(path: str) -> int:
    from blurr_tpu_torch.data import ShardedDataset

    return ShardedDataset(path).num_examples


def record_then_score(recorded) -> list:
    """Phase 48: the open-loop CLI scores each directory the eval agent
    recorded (serial and async) with no transform: bridge.yaml bf16, the
    agent's random draw, every recorded step an example."""
    runs = []
    for label, path, n in recorded:
        argv = ["--config", "config/eval/bridge.yaml", "--checkpoint", "random", "--data", path,
                "--examples", "1000", "--batch-size", str(OPENLOOP_BATCH), "--use-bf16"]
        runs.append(_openloop(label, argv, n, {"flash_attention": 17}))
        _free()
    return runs


def gptq_run(device) -> dict:
    """Phase 50: GPTQ of bridge_pool64_w4a8_steps1.yaml at full width: 6
    fake-env control steps of the fp model as calibration, both mixtures'
    18 layers quantized (wall time and calibration rows printed); on
    held-out captures (episode 101) layer_output_mse below the data-free
    quantize_weight_w4a8's at layers 0, 8 and 17 of each mixture, each
    layer's output error summed over its 7 linears (each linear's ratio
    logged); then one served step: K2 370 launches, the same bits twice.
    Both calibration passes run the naive forward with K1 on: 18 launches
    a flow step of each observation, checked. JAX's one-layer-at-a-time
    walk (every weight alone, a Hessian for each) is timed on layer 0 of
    each mixture beside the batched walk. Returns the launches of the two
    calibration passes and the served step."""
    from blurr_tpu_torch.agent.env_adapter import simpler  # noqa: F401
    from blurr_tpu_torch.config.core import instantiate
    from blurr_tpu_torch.experiments import quant_closed_loop as qcl
    from blurr_tpu_torch.models.pi0.calibrate import (
        WEIGHT_INPUTS,
        collect_pi0_calibration,
        gptq_quantize_pi0,
    )
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.ops.gptq import gptq_quantize_weight, hessian_from_inputs, layer_output_mse
    from blurr_tpu_torch.ops.quant import _QUANT_WEIGHT_KEYS, W4A8Linear, quantize_weight_w4a8
    from blurr_tpu_torch.presets import load_config

    label = "gptq"
    cfg = load_config(GPTQ_CONFIG)
    cfg["joint"]["config"]["use_flash_attn"] = True
    model = PiZero(cfg, device=device, dtype=torch.bfloat16)
    model.init_params(torch.Generator(device=device).manual_seed(0)).eval()
    adapter = instantiate(cfg["env"]["adapter"])
    batches = qcl._calib_batches(model, adapter, cfg, device)
    held_out = qcl._calib_batches(model, adapter, cfg, device, episode_id=101)
    n_layers = len(model.joint["vlm"].layers)
    flow_steps = int(cfg["num_inference_steps"])
    _zero_counts()
    caps = collect_pi0_calibration(model, held_out, num_flow_steps=1)
    torch.cuda.synchronize()
    runs = [_check_calibration_launches(label, "held-out", _counts(), n_layers, len(held_out))]
    fp = {(n, i, key): getattr(model.joint[n].layers[i], attr).weight.detach().t().clone()
          for n in ("vlm", "action") for i in GPTQ_LAYERS
          for key, attr in _QUANT_WEIGHT_KEYS.items()}
    fp_keys = list(fp)
    s = model.spec
    rows = {"vlm": sum(b["input_ids"].numel() for b in batches),
            "action": len(batches) * (s.num_action_tokens + s.num_proprio_tokens)}
    torch.cuda.synchronize()
    timed = _TimedCalibration()
    _zero_counts()
    t0 = time.monotonic()
    with timed:
        gptq_quantize_pi0(model, batches, num_flow_steps=flow_steps)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    runs.append(_check_calibration_launches(label, "calibration", _counts(), n_layers,
                                            len(batches) * flow_steps))
    log(f"{label}: {Path(GPTQ_CONFIG).name} GPTQ of both mixtures' {n_layers} layers in "
        f"{secs:.2f} s (wall; the calibration {timed.secs:.2f} s, the batched walk "
        f"{secs - timed.secs:.2f} s) over {len(batches)} control steps: {rows['vlm']} vlm "
        f"rows (the padded ones zeroed), {rows['action']} action rows (action and proprio "
        f"tokens); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card()}")
    # JAX's walk: a layer at a time, each weight alone with its own Hessian
    one_layer = {}
    for n in ("vlm", "action"):
        gs = model.vlm_w4a8_group_size if n == "vlm" else model.action_w4a8_group_size
        int8_keys = model.vlm_w4a8_int8_keys if n == "vlm" else model.action_w4a8_int8_keys
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for key in _QUANT_WEIGHT_KEYS:
            if key not in int8_keys:
                h = hessian_from_inputs(timed.calib[n][WEIGHT_INPUTS[key]][0].to(device))
                gptq_quantize_weight(fp[(n, 0, key)], h, gs)
        torch.cuda.synchronize()
        one_layer[n] = time.monotonic() - t0
    log(f"{label}: JAX's one-layer-at-a-time walk on layer 0 (each weight alone, a Hessian "
        f"for each): vlm {one_layer['vlm']:.3f} s, action {one_layer['action']:.3f} s, so "
        f"{n_layers * sum(one_layer.values()):.1f} s for both mixtures' {n_layers} layers of "
        f"one shape, against the batched walk's {secs - timed.secs:.2f} s; on {card()}")
    del timed
    sums, linears_below = {}, 0
    for (n, i, key), w in fp.items():
        mod = getattr(model.joint[n].layers[i], _QUANT_WEIGHT_KEYS[key])
        x = caps[n][WEIGHT_INPUTS[key]][i].to(device)
        e_gptq = float(layer_output_mse(x, w, {"q4": mod.q4, "s": mod.s}))
        e_rtn = float(layer_output_mse(x, w, quantize_weight_w4a8(w, w.shape[0] // mod.s.shape[0])))
        log(f"{label}: held-out layer_output_mse {n} layer {i} {key}: GPTQ {e_gptq:.6g}, "
            f"data-free {e_rtn:.6g} ({e_gptq / e_rtn:.3f}x)")
        total = sums.setdefault((n, i), [0.0, 0.0])
        total[0] += e_gptq
        total[1] += e_rtn
        linears_below += e_gptq < e_rtn
    del fp, caps
    for (n, i), (e_gptq, e_rtn) in sums.items():
        log(f"{label}: held-out output error of {n} layer {i}, its 7 linears summed: GPTQ "
            f"{e_gptq:.6g}, data-free {e_rtn:.6g} ({e_gptq / e_rtn:.3f}x)")
    log(f"{label}: GPTQ below the data-free rounding at {linears_below} of {len(fp_keys)} "
        f"linears and {sum(g < r for g, r in sums.values())} of {len(sums)} layers")
    if not all(g < r for g, r in sums.values()):
        raise RuntimeError(f"{label}: GPTQ's held-out layer error is not below the data-free "
                           f"rounding's: {sums}")
    per_step = launches_per_step(model, W4A8Linear)
    b = batches[0]
    noise = torch.randn(1, s.num_action_tokens, s.action_dim, device=device,
                        generator=torch.Generator(device=device).manual_seed(1)).bfloat16()
    args = (b["input_ids"], b["attention_mask"], b["pixel_values"], b["proprios"], noise)
    _zero_counts()
    first = model.infer_action(*args)
    torch.cuda.synchronize()
    launches = _counts()
    runs.append(launches)
    again = model.infer_action(*args)
    log(f"{label}: the GPTQ model served a step: {launches['int4_matmul']} int4 launches "
        f"({per_step} w4a8 linears), {launches['flash_attention']} flash launches, the same "
        f"bits on a second step {torch.equal(first, again)}, finite "
        f"{bool(torch.isfinite(first).all())}")
    if not (launches["int4_matmul"] == per_step == W4A8_STEP_LAUNCHES
            and launches["flash_attention"] == 17 and torch.equal(first, again)
            and torch.isfinite(first).all()):
        raise RuntimeError(f"{label}: the served step is wrong: {launches}")
    del model
    _free()
    return {name: sum(run[name] for run in runs) for name in KERNEL_NAMES}


def _check_calibration_launches(label, what, launches: dict, n_layers: int,
                                forwards: int) -> dict:
    """A calibration pass's counts: K1 once a layer in each of its naive
    forwards (one an observation and flow step), no other kernel (the
    mixtures are still fp)."""
    want = {name: 0 for name in KERNEL_NAMES}
    want["flash_attention"] = n_layers * forwards
    log(f"{label}: the {what} pass launched {launches} ({n_layers} layers x {forwards} "
        f"naive forwards of K1 wanted)")
    if launches != want:
        raise RuntimeError(f"{label}: the {what} pass launched {launches}, not {want}")
    return launches


class _TimedCalibration:
    """While entered, ``calibrate.collect_pi0_calibration``'s wall time
    (``secs``, summed) and its last result (``calib``), as
    ``gptq_quantize_pi0`` calls it."""

    def __init__(self):
        self.secs, self.calib = 0.0, None

    def __enter__(self):
        from blurr_tpu_torch.models.pi0 import calibrate

        self.inner = inner = calibrate.collect_pi0_calibration

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            self.calib = inner(*args, **kw)
            torch.cuda.synchronize()
            self.secs += time.monotonic() - t0
            return self.calib

        calibrate.collect_pi0_calibration = timed
        return self

    def __exit__(self, *exc):
        from blurr_tpu_torch.models.pi0 import calibrate

        calibrate.collect_pi0_calibration = self.inner


def closed_loop() -> dict:
    """Phase 51: experiments/quant_closed_loop's pool64 variants as a user
    runs them (in-process): bf16, w4a8 and w4a8 GPTQ, CLOSED_LOOP_EPISODES
    each (the experiment rolls 2; one is a cut of its depth to keep the
    script inside its time limit), the report lines against the bf16
    control."""
    from blurr_tpu_torch.experiments import quant_closed_loop as qcl

    _zero_counts()
    t0 = time.monotonic()
    episodes, qcl.EPISODES = qcl.EPISODES, CLOSED_LOOP_EPISODES
    try:
        out = qcl.main(list(CLOSED_LOOP_VARIANTS))
    finally:
        qcl.EPISODES = episodes
    torch.cuda.synchronize()
    launches = _counts()
    steps = {tag: len(out[tag][0]) for tag in CLOSED_LOOP_VARIANTS}
    log(f"closed-loop: {list(CLOSED_LOOP_VARIANTS)} in {time.monotonic() - t0:.1f} s, env "
        f"steps {steps}, kernel launches {launches}; on {card()}")
    for line in out["report"]:
        log(f"closed-loop: {line}")
    if len(out["report"]) != 2 or len(set(steps.values())) != 1 or not all(
            np.isfinite(out[tag][1]).all() for tag in CLOSED_LOOP_VARIANTS):
        raise RuntimeError(f"closed-loop: {out['report']}")
    _free()
    return launches


# ---------------------------------------------------------------------------
# Tensor and data parallelism: two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

TP = 2
# K1 on a rank of a tp=2 Pi-0: its 8/tp query heads over the one KV head, at
# the 277-row prefill (bridge.yaml) and the 97-row one (pool64)
TP2_FLASH_SHAPES = [(1, 4, 1, 277, 277, 256), (1, 4, 1, 97, 97, 256)]
# (M, K, N, G) of the pool64 w4a8 step's tensor-parallel w4a8 linears (k and
# v stay whole): vlm q/o, gate/up, down at the 96-token prefill; action q,
# o, gate/up, down at M 1 (proprio prefill) and 4 (decode). A rank runs K2 on
# its NB/tp blocks of the packing pick_block_layout(N, tp) gives, over the
# whole K (a row-parallel input is gathered first)
TP2_PI0_INT4 = [(96, 2048, 2048, 4), (96, 2048, 16384, 4), (96, 16384, 2048, 32),
                *[(m, k, n, g) for m in (1, 4) for k, n, g in (
                    (1024, 2048, 2), (2048, 1024, 4), (1024, 4096, 2), (4096, 1024, 8))]]
# (M, K, N, G) of the pool64 w4a8 step's w4a8 products that tp=2 keeps whole
# (vlm and action k and v: Gemma is multi-query), which shard_params still
# re-lays for the model axis (repack_w4a8: pick_block_layout(256, 2) is BN 128
# x NB 2 where one rank's packing is BN 256 x NB 1)
TP2_PI0_INT4_WHOLE = [(96, 2048, 256, 4), (1, 1024, 256, 2), (4, 1024, 256, 2)]
# OpenVLA-7B's (all its LLM linears split): q/k/v/o, gate/up, down and the
# head, at M 1 (decode) and 288 (the prompt)
TP2_OPENVLA_INT4 = [(m, k, n, g) for m in (1, 288) for k, n, g in (
    (4096, 4096, 8), (4096, 11008, 8), (11008, 4096, 43), (4096, 32064, 8))]
# (M, K, N) of the pool64 int8 step's tensor-parallel int8 linears on a rank:
# q and gate/up cut on N, o and down on K (k, v and the action encoder whole)
TP2_INT8_SHAPES = [(m, k, n) for m in (1, 4) for k, n in (
    (1024, 1024), (1024, 2048), (2048, 1024))]
TP2_OPENVLA_FRAMES = 2
DP2_CLIENTS = 4
# open-loop metrics at --dp 2 against --dp 1: each rank scores 4 rows of a
# batch of 8, and a bf16 step of another row count rounds otherwise; the
# metrics are means over 20 x 4 x 7 errors
OPENLOOP_DP_RTOL = 2e-2


def _pi0_prefix_mask(b, sq, device):
    """A Pi-0 prefix mask over ``sq`` rows (the prompt and one proprio
    token), 10 pad rows fully masked."""
    from blurr_tpu_torch.ops.masks import pi0_prefix_mask

    am = torch.zeros(b, sq - 1, dtype=torch.int32, device=device)
    am[:, :sq - 11] = 1
    return pi0_prefix_mask(am, sq - 1, 1)


def _tp2_flash(device) -> list:
    """K1 at each rank's shape of a tp=2 Pi-0 prefill, bf16, against its
    plain version (and the same bits twice), timed beside SDPA and its
    bound."""
    from blurr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    out = []
    for shape in TP2_FLASH_SHAPES:
        b, nh, kvh, sq, skv, d = shape
        mask = _pi0_prefix_mask(b, sq, device)
        err = _hold_flash(shape, torch.bfloat16, BF16_TOL, "tp2-kernels", device, mask=mask)
        q, k, v, _ = _attention_inputs(shape, device, mask=mask)
        qc, kc, vc = q.bfloat16(), k.bfloat16(), v.bfloat16()
        t = _kernel_times(lambda: flash_attention(qc, kc, vc, mask),
                          lambda: flash_attention_reference(qc, kc, vc, mask),
                          lambda: torch.nn.functional.scaled_dot_product_attention(
                              qc, kc, vc, attn_mask=mask[:, None], enable_gqa=True))
        least = _bound((qc, kc, vc, mask), (qc,), 4 * b * nh * sq * skv * d, "bf16")
        log(f"tp2-kernels: flash_attention time at {shape} bf16: {_fmt_times(t)}; bound "
            f"{least['bound_ms']:.5f} ms ({least['bound_by']}), {least['bound_ms'] / t['graph_ms']:.1%} "
            f"of it reached in a CUDA graph; on {card()}")
        out.append({"shape": list(shape), "max_abs_err": err, **t, **least})
    return out


def _tp2_int4(g, shape, label) -> dict:
    """K2 at one rank's column blocks of an (M, K, N, G) w4a8 product packed
    for tp=2: each rank's shard bit-equal to its plain version and to the
    matching columns of the unsharded K2 output, rank 0's timed in a CUDA
    graph beside its bound and a bf16 matmul of its dense columns."""
    from blurr_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_reference, pick_block_layout

    m, k, n, groups = shape
    bn, n_pad = pick_block_layout(n, TP)
    x, packed, s, q = _int4_inputs(g, m, k, n_pad, groups, bn=bn)
    whole = int4_matmul(x, packed, s)
    nb, w = packed.shape[0] // TP, n_pad // TP
    shards = []
    for r in range(TP):
        pr, sr = packed[r * nb:(r + 1) * nb].contiguous(), s[:, r * w:(r + 1) * w].contiguous()
        out = int4_matmul(x, pr, sr)
        ref = int4_matmul_reference(x, pr, sr)
        again = torch.equal(out, int4_matmul(x, pr, sr))
        torch.cuda.synchronize()
        ok = torch.equal(out, ref) and torch.equal(out, whole[:, r * w:(r + 1) * w]) and again
        if not ok:
            raise RuntimeError(f"{label}: K2's rank-{r} shard of {shape} is not bit-equal to "
                               "its plain version and the unsharded columns")
        shards.append((pr, sr, out))
    pr, sr, out = shards[0]
    graph = _graph_ms(lambda: int4_matmul(x, pr, sr))
    plain = _graph_ms(lambda: int4_matmul_reference(x, pr, sr))
    least = _bound((x, pr, sr), (out,), 2 * m * k * w, "int8")
    xb, wb = x.bfloat16(), q[:, :w].bfloat16()
    dense = _graph_ms(lambda: torch.matmul(xb, wb))
    log(f"{label}: int4_matmul rank shard of (M, K, N, G)={shape}: (M, K, N_pad/tp, G)="
        f"{(m, k, w, groups)} BN {bn} ({nb} of {packed.shape[0]} blocks a rank), each rank "
        f"bit-equal to its plain version and to the unsharded output's columns; graph_ms "
        f"{graph:.5f} (plain {plain:.5f}), bound {least['bound_ms']:.5f} ms "
        f"({least['bound_by']}), {least['bound_ms'] / graph:.1%} of it reached; bf16 matmul "
        f"of the dense columns graph_ms {dense:.5f}; on {card()}")
    return {"shape": [m, k, w, groups], "bn": bn, "max_abs_err": 0.0, "graph_ms": graph,
            "plain_graph_ms": plain, "dense_bf16_graph_ms": dense, **least}


def _tp2_int4_whole(g, shape, label) -> dict:
    """K2 at an (M, K, N, G) w4a8 product that tp=2 keeps whole, on the
    packing ``repack_w4a8`` re-lays for the model axis: bit-equal to its
    plain version and to K2 on the one-rank packing, timed in a CUDA graph
    beside its bound and a bf16 matmul of the dense weight."""
    from blurr_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_reference
    from blurr_tpu_torch.ops.quant import repack_w4a8

    m, k, n, groups = shape
    x, packed, s, q = _int4_inputs(g, m, k, n, groups)
    relaid = repack_w4a8({"q4": packed, "s": s[:, :n]}, TP)["q4"]
    one = int4_matmul(x, packed, s)
    out = int4_matmul(x, relaid, s)
    again = torch.equal(out, int4_matmul(x, relaid, s))
    ref = int4_matmul_reference(x, relaid, s)
    torch.cuda.synchronize()
    if not (relaid.shape != packed.shape and torch.equal(out, ref) and torch.equal(out, one)
            and again):
        raise RuntimeError(f"{label}: K2 on the re-laid packing of {shape} is not bit-equal "
                           "to its plain version and the one-rank packing's output")
    bn = relaid.shape[2]
    graph = _graph_ms(lambda: int4_matmul(x, relaid, s))
    plain = _graph_ms(lambda: int4_matmul_reference(x, relaid, s))
    least = _bound((x, relaid, s), (out,), 2 * m * k * n, "int8")
    xb, wb = x.bfloat16(), q.bfloat16()
    dense = _graph_ms(lambda: torch.matmul(xb, wb))
    log(f"{label}: int4_matmul whole product (M, K, N, G)={shape} on the packing re-laid for "
        f"tp={TP}: BN {bn} x NB {relaid.shape[0]} (one rank's: BN {packed.shape[2]} x NB "
        f"{packed.shape[0]}), bit-equal to its plain version and to the one-rank packing's "
        f"output; graph_ms {graph:.5f} (plain {plain:.5f}), bound {least['bound_ms']:.5f} ms "
        f"({least['bound_by']}), {least['bound_ms'] / graph:.1%} of it reached; bf16 matmul "
        f"of the dense weight graph_ms {dense:.5f}; on {card()}")
    return {"shape": [m, k, n, groups], "bn": bn, "whole": True, "max_abs_err": 0.0,
            "graph_ms": graph, "plain_graph_ms": plain, "dense_bf16_graph_ms": dense, **least}


def _tp2_int8(device, shape, label: str = "tp2-kernels") -> dict:
    """K3 at one rank's (M, K, N) of a tp=2 int8 step, fp32 and bf16 x
    against its plain version (as ``int8_vs_plain``), timed in a CUDA graph
    beside its bound and the library's int8 weight-only product."""
    from blurr_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference

    g = torch.Generator(device=device).manual_seed(5)
    m, k, n = shape
    x = torch.randn(m, k, device=device, generator=g) * 2
    q = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=device, generator=g)
    s = torch.rand(n, device=device, generator=g) * 2e-4 + 1e-5
    ref = int8_matmul_reference(x, q, s)
    top, worst = ref.abs().max().item(), 0.0
    for dtype in (torch.float32, torch.bfloat16):
        out = int8_matmul(x.to(dtype), q, s)
        again = torch.equal(out, int8_matmul(x.to(dtype), q, s))
        torch.cuda.synchronize()
        err = (out.float() - ref).abs()
        bound = INT8_FP32_REL_TOL * top + (BF16_ROUNDING * ref.abs() if dtype == torch.bfloat16
                                           else 0.0)
        if not (torch.isfinite(out).all() and (err <= bound).all() and again):
            raise RuntimeError(f"{label}: K3 disagrees with its plain version at {shape}")
        if dtype == torch.float32:
            worst = err.max().item()
    xb = x.bfloat16()
    graph = _graph_ms(lambda: int8_matmul(xb, q, s))
    plain = _graph_ms(lambda: int8_matmul_reference(xb, q, s))
    q_nk, s_bf16 = q.t().contiguous(), s.bfloat16()
    library = _graph_ms(lambda: torch._weight_int8pack_mm(xb, q_nk, s_bf16))
    least = _bound((xb, q, s), (xb.new_empty(m, n),), 2 * m * k * n, "bf16")
    log(f"{label}: int8_matmul (M, K, N)={shape} fp32 max_abs_err={worst:.3e} (bound "
        f"{INT8_FP32_REL_TOL * top:.3e}), bf16 within one rounding, the same bits twice; "
        f"bf16 graph_ms {graph:.5f} (plain {plain:.5f}), bound {least['bound_ms']:.5f} ms "
        f"({least['bound_by']}), torch._weight_int8pack_mm graph_ms {library:.5f}; on {card()}")
    return {"shape": list(shape), "max_abs_err": worst, "graph_ms": graph,
            "plain_graph_ms": plain, "library_graph_ms": library, **least}


def tp2_kernels_vs_plain(device) -> dict:
    """Phase 54: K1, K2 and K3 at every shape a rank of the tp=2 paths gives
    them (``TP2_*``). Returns their entries by kernel name."""
    g = torch.Generator(device=device).manual_seed(6)
    out = {"flash_attention": _tp2_flash(device),
           "int4_matmul": [_tp2_int4(g, shape, "tp2-kernels")
                           for shape in TP2_PI0_INT4 + TP2_OPENVLA_INT4]
                          + [_tp2_int4_whole(g, shape, "tp2-kernels")
                             for shape in TP2_PI0_INT4_WHOLE],
           "int8_matmul": [_tp2_int8(device, shape) for shape in TP2_INT8_SHAPES]}
    torch.cuda.empty_cache()
    return out


def ranks_shapes_vs_plain(device, int4: set, flash: dict, int8: set, tp2: dict) -> None:
    """Phase 60: every shape rank 0 gave K1, K2 and K3 in phases 55-59 held
    against its plain version: K1 at each with the first mask it met there;
    K2 (bit-equal) and K3 at those phase 54 (``tp2``, its entries) did not
    hold. The ranks of a phase run the same shapes (each holds NB/tp blocks
    of the same packing, or an equal slice), so rank 0's are every rank's."""
    label = "ranks-shapes"
    served_int4_vs_plain(device, int4, {(*e["shape"], e["bn"]) for e in tp2["int4_matmul"]},
                         label=label, what="rank 0 of phases 55-59", by="tp2-kernels",
                         exact=True)
    log(f"{label}: rank 0 of phases 55-59 gave K1 {len(flash)} (shape, dtype) pairs "
        f"{sorted((shape, str(dtype)[6:]) for shape, dtype in flash)}, each held with the "
        "first mask it met there")
    for (shape, dtype), mask in sorted(flash.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_EXACT_TOL
        _hold_flash(shape, dtype, tol, label, device, mask=mask)
    missing = sorted(int8 - {tuple(e["shape"]) for e in tp2["int8_matmul"]})
    log(f"{label}: rank 0 of phases 55-59 gave K3 {len(int8)} shapes (M, K, N) {sorted(int8)}; "
        f"{len(missing)} not held by tp2-kernels{f': {missing}' if missing else ''}")
    for shape in missing:
        _tp2_int8(device, shape, label)
    torch.cuda.empty_cache()


def profile_after_ranks(device) -> None:
    """Phase 61: what phases 55-68 leave in this process: no process group
    and no child process (the threads are logged). Then what torch.profiler
    sees of K6's two kernels, logged and not held: in this script's process
    it has seen no device activity after the parallel phases (PERF.md §7),
    also since they run in child processes, a fault whose cause is not
    known."""
    import multiprocessing

    from torch.profiler import ProfilerActivity, profile

    from blurr_tpu_torch.experiments import bench_fused_ffn
    from blurr_tpu_torch.ops.fused_ffn import fused_ffn

    label = "profile-after-ranks"
    group = torch.distributed.is_initialized()
    children = [p.name for p in multiprocessing.active_children()]
    log(f"{label}: after phases 55-68: process group {group}, child processes {children}, "
        f"threads {[t.name for t in threading.enumerate()]}")
    if group or children:
        raise RuntimeError(f"{label}: the parallel phases left a process group ({group}) or "
                           f"child processes {children}")
    g = torch.Generator(device=device).manual_seed(4)
    m, h, inter = bench_fused_ffn.M, bench_fused_ffn.H, bench_fused_ffn.I
    x = (torch.rand(m, h, generator=g, device=device) * 2 - 1).to(torch.bfloat16)
    weights = bench_fused_ffn.layer_weights(h, inter, g, device)
    fused_ffn(x, *weights)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fused_ffn(x, *weights)
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    ffn = sum(e.count for e in seen if "ffn_kernel" in e.key)
    log(f"{label}: torch.profiler over 10 fused_ffn calls saw {len(seen)} kernel names with "
        f"device time, {ffn} of 20 K6 launches (not held: PERF.md §7)")
    del x, weights
    torch.cuda.empty_cache()


def _rank_counts(server, label, per_request: dict, steps: int) -> dict:
    """Every rank's launches of the served kernels, each ``per_request``
    times ``steps`` (a kernel not named: never); returns their sum over the
    ranks."""
    counts = server.rank_launches()
    log(f"{label}: launches by rank {counts} ({steps} steps; expected per step and rank "
        f"{per_request})")
    for rank, got in enumerate(counts):
        for name, n in got.items():
            if n != per_request.get(name, 0) * steps:
                raise RuntimeError(f"{label}: rank {rank} launched {name} {n} times, not "
                                   f"{per_request.get(name, 0) * steps}")
    return {name: sum(c.get(name, 0) for c in counts) for name in KERNEL_NAMES}


def _serve_ranks(server, label, requests, clients: int = 1):
    """``requests`` ((image, instruction, proprio)) through the port's
    ActionClient from ``clients`` threads, after a warmup and with every
    rank's counts set to 0 just before. Returns (answers in request order,
    the stats, the server still running)."""
    from concurrent.futures import ThreadPoolExecutor

    from blurr_tpu_torch.serving.client import ActionClient

    log(f"{label}: warmup {server.warmup():.2f} s")
    server.rank_launches(zero=True)

    def run(part):
        with ActionClient(port=server.port) as client:
            out = []
            for i in part:
                t = time.monotonic()
                out.append((i, client.predict(*requests[i]), (time.monotonic() - t) * 1000.0))
            return out

    parts = [list(range(c, len(requests), clients)) for c in range(clients)]
    with ThreadPoolExecutor(clients) as pool:
        done = sorted(x for part in pool.map(run, parts) for x in part)
    with ActionClient(port=server.port) as client:
        stats = client.stats()
    log(f"{label}: {len(requests)} requests from {clients} client(s), latency ms (client) "
        f"{[round(ms, 3) for _, _, ms in done]}, server p50 {stats.get('latency_ms_p50')} ms "
        f"(host clock; two ranks time-share one card, so no multi-card speed is claimed; "
        f"on {card()})")
    return [a for _, a, _ in done], stats


def _start_ranks(label, make):
    t0 = time.monotonic()
    server = make()
    torch.cuda.synchronize()
    thread = _start(server)
    log(f"{label}: {server.world} ranks (dp {server.dp} x tp {server.tp}) on backend "
        f"{server.backend}, rank 0 on {server.device}; built and sharded in "
        f"{time.monotonic() - t0:.2f} s; rank 0's resident parameters and buffers "
        f"{resident_bytes(server.model)} B, allocated {torch.cuda.memory_allocated()} B")
    return server, thread


def _held_to_one_rank(label, answers, want, tol) -> float:
    worst = max(float(np.abs(a - b).max()) for a, b in zip(answers, want))
    log(f"{label}: answers against the one-process server's on the same weights and "
        f"requests: max_abs_diff={worst:.3e} (tol {tol:g})")
    if not worst <= tol:
        raise RuntimeError(f"{label}: answers {worst} from the one-process server's")
    return worst


def served_tp2(device, label: str, config: str, one_rank: str, per_step: dict,
               cache_fp=None) -> dict:
    """Phases 55 and 57: ``config`` at full width served by two tensor-parallel
    ranks (K1 on), drawn from the seed of the one-process phase
    ``one_rank``: its N_REQUESTS answers within MODEL_TOL of that phase's,
    each rank's launches ``per_step`` a step, rank 0's resident weights
    against the one-process server's and one step of rank 0's kernels
    under the profiler."""
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.server import ActionServer

    cfg = load_config(config)
    if config.endswith("bridge.yaml"):
        apply_preset(cfg, "blurr")
    if cache_fp is not None:
        cfg["action_quantization"]["cache_fp_weight"] = cache_fp
    cfg["joint"]["config"]["use_flash_attn"] = True
    image, proprio, want, whole = ONE_RANK[one_rank]
    server, thread = _start_ranks(label, lambda: ActionServer(
        cfg, "random", device=device, seed=0, tp=TP))
    try:
        weights = resident_bytes(server.model)
        log(f"{label}: resident weight bytes per rank {weights} B ({weights / 1e9:.3f} GB) "
            f"against one rank's {whole} B ({whole / 1e9:.3f} GB): {weights / whole:.3f}x")
        answers, stats = _serve_ranks(
            server, label, [(image, "put the spoon on the towel", proprio)] * N_REQUESTS)
        launches = _rank_counts(server, label, per_step, N_REQUESTS)
        _step_device_time(server, image, proprio, f"{label} (rank 0's kernels)",
                          *per_step)
    finally:
        _stop(server, thread)
    for a in answers:
        _check_chunk(label, a)
    _held_to_one_rank(label, answers, want, MODEL_TOL)
    del server
    _free()
    return launches


def served_dp2(device) -> dict:
    """Phase 56: bridge.yaml blurr bf16 over two data ranks, max_batch 4:
    DP2_CLIENTS concurrent clients (each rank 17 K1 a batch); then one bucket
    of 4 requests through both ranks against rank 0 computing the whole
    bucket alone (it holds the whole model), within MODEL_TOL."""
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.server import ActionServer

    label = "serve-dp2"
    cfg = load_config("config/eval/bridge.yaml")
    apply_preset(cfg, "blurr")
    cfg["joint"]["config"]["use_flash_attn"] = True
    pool = _pi0_requests(cfg["vision"]["config"]["image_size"], 4)
    server, thread = _start_ranks(label, lambda: ActionServer(
        cfg, "random", device=device, seed=0, dp=2, max_batch=4,
        batch_window_ms=BATCH_WINDOW_MS))
    try:
        log(f"{label}: buckets {server._buckets()} (the smallest is dp)")
        answers, stats = _serve_ranks(server, label, [pool[i % 4] for i in range(8)],
                                      clients=DP2_CLIENTS)
        launches = _rank_counts(server, label, {"flash_attention": 17}, stats["batches_total"])
        log(f"{label}: {stats['batches_total']} batches, occupancy "
            f"{stats['batch_occupancy_mean']}, padding {stats['padding_frac']}")
        inputs = [server._prepare(*r) for r in pool]
        bucket = tuple(torch.cat([x[i] for x in inputs]) for i in range(4))
        with server._lock:
            both = server._step(*bucket, request_idx=7)
            alone = server._infer(*bucket, server.noise(7, 4)).float().cpu().numpy()
    finally:
        _stop(server, thread)
    for a in answers:
        _check_chunk(label, a)
    _held_to_one_rank(f"{label} bucket of 4", list(both), list(alone), MODEL_TOL)
    del server
    _free()
    return launches


def served_tp2_openvla(device) -> dict:
    """Phase 58: OpenVLA-7B w4a8 AR on two tensor-parallel ranks (the LLM
    drawn quantized from the one-process phase's seed): the same answers
    (tokens) as phase 26 on TP2_OPENVLA_FRAMES frames, each rank K2
    OPENVLA_AR_LAUNCHES a request; then a hot reload (the weights drawn and
    re-sharded on every rank) and the first frame again, the same answer."""
    from blurr_tpu_torch.serving.openvla_server import OpenVLAActionServer

    label = "serve-tp2-openvla"
    want, whole = ONE_RANK["serve-openvla-7b-w4a8"]
    frames = _openvla_frames()[:TP2_OPENVLA_FRAMES]
    server, thread = _start_ranks(label, lambda: OpenVLAActionServer(
        "random-7b", quantization="w4a8", device=device, tp=TP))
    try:
        weights = resident_bytes(server.model)
        log(f"{label}: resident weight bytes per rank {weights} B against one rank's {whole} "
            f"B: {weights / whole:.3f}x")
        requests = [(f, OPENVLA_INSTRUCTION, [0.0] * 7) for f in frames]
        answers, _ = _serve_ranks(server, label, requests)
        launches = _rank_counts(server, label, {"int4_matmul": OPENVLA_AR_LAUNCHES},
                                len(frames))
        t0 = time.monotonic()
        server.reload_checkpoint("")
        log(f"{label}: hot reload (drawn again, re-sharded on every rank) "
            f"{time.monotonic() - t0:.2f} s")
        server.rank_launches(zero=True)
        again = server.predict(*requests[0])
        more = _rank_counts(server, f"{label} after the reload",
                            {"int4_matmul": OPENVLA_AR_LAUNCHES}, 1)
    finally:
        _stop(server, thread)
    for a, b in zip(answers, want):
        if not np.array_equal(a, b):
            raise RuntimeError(f"{label}: {a} against the one-process answer {b}")
    if not np.array_equal(again, answers[0]):
        raise RuntimeError(f"{label}: after the reload {again}, before {answers[0]}")
    log(f"{label}: {len(frames)} answers equal the one-process server's (the same tokens); "
        f"after the reload the same answer")
    del server
    _free()
    return {name: launches[name] + more[name] for name in KERNEL_NAMES}


def openloop_dp2(device, tmp: str) -> dict:
    """Phase 59: scripts/eval_openloop_torch.py --dp 2 in-process on
    bridge.yaml bf16 with K1 on (a YAML over bridge.yaml that sets it, so
    the spawned rank reads it too): its metrics against phase 49's --dp 1
    run of the same config within OPENLOOP_DP_RTOL (rows scored in batches
    of 4 instead of 8), each rank's 17 K1 a batch (the spawned rank's counts
    come back with its reply)."""
    from blurr_tpu_torch.paths import config_root

    config = os.path.join(tmp, "bridge_flash.yaml")
    with open(config, "w") as f:
        f.write(f"defaults:\n  - {config_root() / 'eval' / 'bridge'}\n"
                "joint:\n  config:\n    use_flash_attn: true\n")
    argv = ["--config", config, "--checkpoint", "random", "--examples", "20",
            "--batch-size", str(OPENLOOP_BATCH), "--use-bf16", "--dp", "2"]
    one = ONE_RANK["openloop-bf16"]
    _zero_counts()
    t0 = time.monotonic()
    others = []
    two = _cli("eval_openloop_torch").main(argv, rank_launches=others)
    torch.cuda.synchronize()
    counts = [_counts(), *({name: c.get(name, 0) for name in KERNEL_NAMES} for c in others)]
    batches = -(-20 // OPENLOOP_BATCH)
    log(f"openloop-dp2: --dp 2 in {time.monotonic() - t0:.2f} s (two ranks, gloo, one "
        f"card): mse {two['mse']:.6f} mae {two['mae']:.6f} against --dp 1's {one['mse']:.6f} "
        f"{one['mae']:.6f}; launches by rank {counts}; on {card()}")
    for key in ("mse", "mae", "mse_prefix", "eef_l2"):
        if not abs(two[key] - one[key]) <= OPENLOOP_DP_RTOL * abs(one[key]):
            raise RuntimeError(f"openloop-dp2: {key} {two[key]} against --dp 1's {one[key]}")
    if two["examples"] != one["examples"] or set(two) != OPENLOOP_METRICS:
        raise RuntimeError(f"openloop-dp2: metrics {two}")
    if len(counts) != 2:
        raise RuntimeError(f"openloop-dp2: launch counts of {len(counts)} ranks, not 2")
    for rank, got in enumerate(counts):
        _check_eval_launches(f"openloop-dp2 (rank {rank})", got, {"flash_attention": 17},
                             batches)
    _free()
    return {name: sum(c[name] for c in counts) for name in KERNEL_NAMES}


# ---------------------------------------------------------------------------
# M14's training half: data-, tensor-parallel and FSDP training (phases 62-65)
# ---------------------------------------------------------------------------

# every parallel training phase runs the trainer's own main(argv) in child
# processes (rank 0 included): this process joins no process group
CHILD_DEADLINE_S = 600.0
# losses of a parallel run against the one-card run of the same argv: bf16
# products of another row count (dp) and the row sums' other order (tp)
# round otherwise, as the open-loop metrics at --dp 2 do (OPENLOOP_DP_RTOL);
# the first step is a forward of fresh weights, the next two follow updates
# of the warmup's 1e-6 learning rate
PARALLEL_TRAIN_RTOL = 2e-2
# a tp=2 rank's resident parameters and buffers against one card's: all but
# Gemma's whole k and v, the norms, the action and proprio encoders and the
# projector split in two
TP2_TRAIN_BYTES_MAX = 0.6
# an FSDP rank's parameter and moment bytes against the one-card run's (a
# plain data-parallel rank holds the one card's): JAX's
# test_fsdp_reduces_per_device_state_bytes
FSDP_BYTES_MAX = 0.55
FSDP_ARGS = ["--config", "config/eval/bridge.yaml", "--train-scope", "action_expert",
             "--dtype", "master-fp32", "--batch-size", str(TRAIN_BATCH), "--seed", "0",
             "--log-every", "1", "--steps", "2"]
VLA_TP_ARGS = ["--model-id", "random-7b", "--quantize-base", "w8a8", "--lora-rank", "32",
               "--batch-size", "2", "--steps", "2", "--log-every", "1"]
# the one-card runs the parallel phases are held against, by phase
ONE_CARD = {}


def _child_main(fn, args, env, q) -> None:
    """A spawned child: ``fn(*args)`` with ``env`` set, its result or its
    error (as text) put on ``q``."""
    os.environ.update(env)
    try:
        torch.cuda.set_device(0)
        q.put(("ok", fn(*args)))
    except BaseException as exc:
        import traceback

        q.put(("error", f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}"))


def _start_children(calls, deadline_s: float = CHILD_DEADLINE_S):
    """Start each (fn, args, env) of ``calls`` in a spawned child process,
    all at once (not daemons: a trainer's rank 0 spawns its other ranks);
    ``_children_results`` reads them by the deadline."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    started = []
    for fn, args, env in calls:
        q = ctx.Queue()
        p = ctx.Process(target=_child_main, args=(fn, args, env, q))
        p.start()
        started.append((p, q))
    return started, time.monotonic() + deadline_s


def _children_results(label, children) -> list:
    """The results of ``_start_children``'s children in order, or raise
    with a child's error; every child is joined (or killed) by the
    deadline."""
    import queue as queue_lib

    started, deadline = children
    out, errors = [], []
    try:
        for i, (p, q) in enumerate(started):
            while True:
                try:
                    kind, value = q.get(timeout=1.0)
                    break
                except queue_lib.Empty:
                    if not p.is_alive():
                        kind, value = "error", f"child {i} died (exit code {p.exitcode})"
                        break
                    if time.monotonic() > deadline:
                        kind, value = "error", f"child {i} did not answer by the deadline"
                        break
            if kind == "error":
                errors.append(f"child {i}: {value}")
            out.append(value)
    finally:
        for p, _ in started:
            p.join(max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(5.0)
    if errors:
        raise RuntimeError(f"{label}: " + "\n".join(errors))
    return out


def _in_children(label, calls, deadline_s: float = CHILD_DEADLINE_S) -> list:
    """Run each (fn, args, env) of ``calls`` in a spawned child process, all
    at once, and return their results in order."""
    return _children_results(label, _start_children(calls, deadline_s))


def _train_child(script, argv):
    """In a child: the trainer's main(argv) on the card, the K2 shapes this
    process gave (rank 0's, or this rank's under --multihost) and every
    rank's summary (``parallel/train.py:rank_summary``)."""
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with _RecordInt4Shapes() as rec:
        run = _cli(script).main([*argv, "--device", "cuda"])
    return {"ranks": run.ranks, "shapes": rec.seen, "seconds": time.monotonic() - t0}


def _multihost_env(rank: int, world: int, port: int) -> dict:
    """What a launcher (torchrun) sets for ``rank`` of a one-host group."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _check_ranks(label, ranks, steps: int, per_step, want_losses) -> list:
    """Every rank's launches ``per_step`` (a dict, or a list of one dict
    per rank) times ``steps`` and its losses equal to rank 0's; rank 0's
    against ``want_losses`` within PARALLEL_TRAIN_RTOL. Returns the
    relative loss errors."""
    for r in ranks:
        log(f"{label}: rank {r['rank']}: losses {[round(x, 6) for x in r['losses']]}, launches "
            f"{r['launches']}, parameters and buffers {r['param_bytes']} B, moments "
            f"{r['moment_bytes']} B, peak {r['peak_bytes'] / 2**30:.2f} GiB; on {card()}")
        counts = per_step[r["rank"]] if isinstance(per_step, list) else per_step
        want = {n: counts.get(n, 0) * steps for n in ("flash_attention", "int4_matmul",
                                                      "int8_matmul")}
        if r["launches"] != want:
            raise RuntimeError(f"{label}: rank {r['rank']} launched {r['launches']}, not {want}")
        if r["losses"] != ranks[0]["losses"] or len(r["losses"]) != steps:
            raise RuntimeError(f"{label}: rank {r['rank']}'s losses {r['losses']} against rank "
                               f"0's {ranks[0]['losses']}")
    got, want = np.asarray(ranks[0]["losses"]), np.asarray(want_losses[:steps])
    rel = (np.abs(got - want) / np.abs(want)).tolist()
    log(f"{label}: losses {got.tolist()} against one card's {want.tolist()}: relative "
        f"{[f'{x:.2e}' for x in rel]} (tol {PARALLEL_TRAIN_RTOL:g})")
    if not (np.isfinite(got).all() and max(rel) <= PARALLEL_TRAIN_RTOL):
        raise RuntimeError(f"{label}: losses {got} against one card's {want}")
    return rel


def _train_launches(ranks) -> dict:
    return {n: sum(r["launches"].get(n, 0) for r in ranks) for n in KERNEL_NAMES}


def parallel_training(data: str, tmp: str) -> tuple:
    """Phases 62-68 in four groups of children, each group at once and the
    groups one after another: 62 and 63 (peaks ~50 GB), 64's one-card run
    and FSDP ranks (~53 GB), 65's tp=1 and tp=2 (~37 GB) with 68's two ring
    ranks (~14 GB), 66 and 67 (~50 GB); with phases 55-59's child beside
    them (~16 GB) the card's 80 GB holds each group. Returns (the launches
    of every rank, the K2 shapes of 62's ranks and of 63's, 66's and 67's
    rank 0)."""
    from blurr_tpu_torch.parallel.mesh import free_tcp_init_method

    port = int(free_tcp_init_method().rsplit(":", 1)[1])
    ring_store = os.path.join(tmp, "ring_store")  # the ring ranks meet through a file
    qlora = [*TRAIN_ARGS, "--data", data, "--steps", str(TRAIN_STEPS), "--stop-after", "3"]
    pi0, vla = "train_pi0_flow_torch", "train_openvla_lora_torch"
    t0 = time.monotonic()
    *dp2, tp2 = _in_children("parallel-training", [
        *((_train_child, (pi0, [*qlora, "--dp", "2", "--multihost"]),
           _multihost_env(r, 2, port)) for r in range(2)),
        (_train_child, (pi0, [*qlora, "--tp", "2"]), {})])
    t1 = time.monotonic()
    fsdp1, fsdp2 = _in_children("parallel-training", [
        (_train_child, (pi0, FSDP_ARGS), {}),
        (_train_child, (pi0, [*FSDP_ARGS, "--dp", "2", "--fsdp"]), {})])
    t2 = time.monotonic()
    vla1, vla2, *ring = _in_children("parallel-training", [
        (_train_child, (vla, VLA_TP_ARGS), {}),
        (_train_child, (vla, [*VLA_TP_ARGS, "--tp", "2"]), {}),
        *((_ring_rank, (r, ring_store), {}) for r in range(2))])
    t3 = time.monotonic()
    pp2, sp2 = _in_children("parallel-training", [
        (_pp_train_child, (pi0, [*qlora, "--pp", "2"], os.path.join(tmp, "pp2")), {}),
        (_train_child, (pi0, [*qlora, "--sp", "2"]), {})])
    log(f"parallel-training: 66 and 67 at once in {time.monotonic() - t3:.1f} s (main() "
        f"{[round(o['seconds'], 1) for o in (pp2, sp2)]} s); 65 and 68 at once in "
        f"{t3 - t2:.1f} s")
    # 62 and 63: against phase 37's first three losses
    want = ONE_CARD["train-qlora-w4a8"]
    dp2_ranks = [o["ranks"][0] for o in dp2]
    _check_ranks("train-dp2-qlora-w4a8", dp2_ranks, 3, {"int4_matmul": TRAIN_K2_PER_STEP},
                 want["losses"])
    label = "train-tp2-qlora-w4a8"
    _check_ranks(label, tp2["ranks"], 3, {"int4_matmul": TRAIN_K2_PER_STEP}, want["losses"])
    ratio = tp2["ranks"][0]["param_bytes"] / want["param_bytes"]
    log(f"{label}: rank 0's resident parameters and buffers {tp2['ranks'][0]['param_bytes']} B "
        f"against one card's {want['param_bytes']} B: {ratio:.3f}x (max {TP2_TRAIN_BYTES_MAX})")
    if ratio > TP2_TRAIN_BYTES_MAX:
        raise RuntimeError(f"{label}: rank 0 holds {ratio:.3f}x one card's bytes")
    # 64: the FSDP ranks' state against the one-card run's
    label = "train-fsdp-dp2"
    base = fsdp1["ranks"][0]
    _check_ranks(label + " (one card)", fsdp1["ranks"], 2, {}, base["losses"])
    _check_ranks(label, fsdp2["ranks"], 2, {}, base["losses"])
    whole = base["param_bytes"] + base["moment_bytes"]
    held = [r["param_bytes"] + r["moment_bytes"] for r in fsdp2["ranks"]]
    log(f"{label}: parameter and moment bytes per rank {held} against one card's {whole} B: "
        f"{[f'{b / whole:.3f}' for b in held]}x (max {FSDP_BYTES_MAX})")
    if max(held) > FSDP_BYTES_MAX * whole:
        raise RuntimeError(f"{label}: an FSDP rank holds {max(held) / whole:.3f}x one card's")
    # 65: OpenVLA-7B w8a8 at tp=2 against tp=1
    label = "train-tp2-openvla-w8a8"
    base = vla1["ranks"][0]
    _check_ranks(label + " (tp=1)", vla1["ranks"], 2, {}, base["losses"])
    _check_ranks(label, vla2["ranks"], 2, {}, base["losses"])
    log(f"{label}: rank 0's parameters and buffers {vla2['ranks'][0]['param_bytes']} B against "
        f"tp=1's {base['param_bytes']} B: {vla2['ranks'][0]['param_bytes'] / base['param_bytes']:.3f}x")
    # 66 and 67: against phase 37's first three losses; 68: against
    # grouped_attention on one rank
    _check_pp_sp(pp2, sp2)
    _check_ring(ring)
    ranks = [r for out in (*dp2, tp2, fsdp1, fsdp2, vla1, vla2, pp2, sp2) for r in out["ranks"]]
    shapes = dp2[0]["shapes"] | dp2[1]["shapes"] | tp2["shapes"]
    new = (pp2["shapes"] | sp2["shapes"]) - shapes
    log(f"parallel-training: 66 and 67's rank 0 gave K2 {len(pp2['shapes'] | sp2['shapes'])} "
        f"shapes, {len(new)} not given in 62-63{f': {sorted(new)}' if new else ''}")
    return _train_launches(ranks), shapes | pp2["shapes"] | sp2["shapes"]


# ---------------------------------------------------------------------------
# M14's training half, part 2: pipeline and sequence parallelism and ring
# attention (phases 66-68)
# ---------------------------------------------------------------------------

# K2 a step on each pipeline stage at bridge.yaml QLoRA w4a8, batch 2, 2
# microbatches of one row: stage 0's 9 layers x 21 products x 2, stage 1's
# less the last layer's 8 skipped (vlm and proprio: o, gate, up, down) x 2
PP2_K2_PER_STEP = [9 * 21 * 2, (9 * 21 - 8) * 2]
# ring attention at Pi-0's attention widths (8 query heads over the one KV
# head of 256), fp32, the clamp 50, causal; the second case masks the
# last RING_PAD keys by k_valid
RING_SHAPE = (1, 8, 1, 8192, 256)
RING_PAD = 512
# the ring's output and input gradients against grouped_attention on one
# rank at the same inputs: JAX's dryrun_multichip section 8 bounds (output
# within atol + rtol |plain|, 5e-5 each; gradients atol 5e-5, rtol 5e-4)
RING_OUT_TOL = 5e-5
RING_GRAD_RTOL, RING_GRAD_ATOL = 5e-4, 5e-5


def _pp_train_child(script, argv, save_dir):
    """In a child: ``_train_child`` of the pipelined run, then its
    --save-dir (rank 0 wrote the gathered one-card tree) on one card:
    ActionServer (bridge.yaml blurr) with the adapters rebuilt over the int4
    bases, one request through the client, K2 launches of it."""
    from blurr_tpu_torch.ops.lora import LoRALinear
    from blurr_tpu_torch.ops.quant import W4A8Linear
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.client import ActionClient
    from blurr_tpu_torch.serving.server import ActionServer

    out = _train_child(script, [*argv, "--save-dir", save_dir])
    _free()
    label = "train-pp2-serve"
    cfg = load_config("config/eval/bridge.yaml")
    apply_preset(cfg, "blurr")
    t0 = time.monotonic()
    server = ActionServer(cfg, save_dir, device=torch.device("cuda", 0), seed=0)
    q = server.model.joint["vlm"].layers[0].q_proj
    if not (isinstance(q, LoRALinear) and isinstance(q.base, W4A8Linear)):
        raise RuntimeError(f"{label}: the adapter tree was not rebuilt")
    thread = _start(server)
    try:
        size = cfg["vision"]["config"]["image_size"]
        image = np.random.RandomState(0).randint(0, 256, (size, size, 3), np.uint8)
        with ActionClient(port=server.port) as client:
            client.predict(image, "put the spoon on the towel", [0.0] * 7)  # warm
            _zero_counts()
            action = client.predict(image, "put the spoon on the towel", [0.0] * 7)
        launches = _counts()
    finally:
        _stop(server, thread)
    _check_chunk(label, action)
    out["served"] = {"seconds": time.monotonic() - t0, "launches": launches,
                     "action": np.asarray(action)}
    del server
    _free()
    return out


def _ring_rank(rank: int, store: str) -> dict:
    """In a child: rank ``rank`` of 2 on cuda:0 over gloo (the ranks meet
    through the file ``store``), ring attention at RING_SHAPE through
    ``ring_attention_whole`` (causal, clamp 50; then with the last
    RING_PAD keys masked), the output and the gradients of
    sum(sin(out)); rank 0 holds them against grouped_attention on the same
    inputs (one query head at a time, to bound its memory) and times a
    call, its gloo exchanges and the plain version's."""
    import datetime

    import torch.distributed as dist

    from blurr_tpu_torch.ops.attention import grouped_attention
    from blurr_tpu_torch.ops.ring_attention import ring_attention_whole
    from blurr_tpu_torch.parallel import mesh as t_mesh

    device = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=120))
    mesh = t_mesh.make_mesh(seq=2)
    gloo = [0.0]
    real = t_mesh.exchange

    def timed_exchange(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real(*a)
        gloo[0] += time.perf_counter() - t

    t_mesh.exchange = timed_exchange
    b, nh, kvh, s, d = RING_SHAPE
    out = {}
    try:
        for case in ("causal", f"causal+pad{RING_PAD}"):
            g = torch.Generator(device=device).manual_seed(11)
            q, k, v = (torch.randn((b, h, s, d), generator=g, device=device)
                       for h in (nh, kvh, kvh))
            valid = None
            if "pad" in case:
                valid = torch.ones((b, s), dtype=torch.bool, device=device)
                valid[:, s - RING_PAD:] = False
            times, exch = [], []
            with torch.no_grad():
                for _ in range(3):
                    gloo[0] = 0.0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ring_attention_whole(q, k, v, mesh, causal=True, k_valid=valid)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    exch.append(gloo[0])
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = ring_attention_whole(*leaves, mesh, causal=True, k_valid=valid)
            grads = torch.autograd.grad(torch.sin(o).sum(), leaves)
            o = o.detach()
            res = {"ms": 1e3 * float(np.median(times)), "gloo_ms": 1e3 * float(np.median(exch))}
            if rank == 0:
                mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))[None]
                if valid is not None:
                    mask = mask & valid[:, None, :]
                ref_grads = [torch.zeros_like(t) for t in (q, k, v)]
                out_err = grad_err = 0.0
                plain_ms = 0.0
                for h in range(nh):  # one query head at a time: the same function
                    qh, kh, vh = (t.clone().requires_grad_() for t in (q[:, h:h + 1], k, v))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ref = grouped_attention(qh, kh, vh, mask)
                    torch.cuda.synchronize()
                    plain_ms += 1e3 * (time.perf_counter() - t0)
                    gq, gk, gv = torch.autograd.grad(torch.sin(ref).sum(), (qh, kh, vh))
                    ref_grads[0][:, h:h + 1] = gq
                    ref_grads[1] += gk
                    ref_grads[2] += gv
                    err = (o[:, h:h + 1] - ref.detach()).abs()
                    out_err = max(out_err, float((err / (RING_OUT_TOL * (1 + ref.detach().abs()))
                                                  ).max()))
                    del ref, qh, kh, vh
                for got, want in zip(grads, ref_grads):
                    bound = RING_GRAD_ATOL + RING_GRAD_RTOL * want.abs()
                    grad_err = max(grad_err, float(((got - want).abs() / bound).max()))
                res.update(out_share=out_err, grad_share=grad_err, plain_ms=plain_ms,
                           max_abs=float(max((a - w).abs().max() for a, w in
                                             zip(grads, ref_grads))))
                del ref_grads
            out[case] = res
            del q, k, v, leaves, o, grads
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        t_mesh.exchange = real
        dist.destroy_process_group()
    out["peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    return out


def _check_ring(ranks) -> None:
    """Phase 68's readings: every case's output and gradients within their
    bounds (shares of the bound, ≤ 1), the times logged."""
    label = "ring-attention-2"
    b, nh, kvh, s, d = RING_SHAPE
    for case in ranks[0]:
        if case == "peak_bytes":
            continue
        r0, r1 = ranks[0][case], ranks[1][case]
        log(f"{label}: {case} q [{b},{nh},{s},{d}] over k/v [{b},{kvh},{s},{d}] fp32, clamp 50, "
            f"two ranks on one card (gloo, through host buffers): output at "
            f"{r0['out_share']:.3g} of its bound ({RING_OUT_TOL:g} + {RING_OUT_TOL:g} |plain|), "
            f"gradients at {r0['grad_share']:.3g} of theirs (atol {RING_GRAD_ATOL:g}, rtol "
            f"{RING_GRAD_RTOL:g}; largest |error| {r0['max_abs']:.3g}); a call {r0['ms']:.2f} / "
            f"{r1['ms']:.2f} ms on ranks 0 / 1, of it gloo {r0['gloo_ms']:.2f} / "
            f"{r1['gloo_ms']:.2f} ms; grouped_attention on one rank (8 calls of one query "
            f"head) {r0['plain_ms']:.2f} ms; on {card()}")
        if not (r0["out_share"] <= 1.0 and r0["grad_share"] <= 1.0):
            raise RuntimeError(f"{label}: {case} disagrees with grouped_attention")
    log(f"{label}: peak {[round(r['peak_bytes'] / 2**30, 2) for r in ranks]} GiB a rank")


def _check_pp_sp(pp2, sp2) -> None:
    """Phases 66 and 67's readings against phase 37's one-card run."""
    want = ONE_CARD["train-qlora-w4a8"]
    label = "train-pp2-qlora-w4a8"
    _check_ranks(label, pp2["ranks"], 3, [{"int4_matmul": n} for n in PP2_K2_PER_STEP],
                 want["losses"])
    for r in pp2["ranks"]:
        log(f"{label}: stage {r['rank']}'s resident parameters and buffers {r['param_bytes']} B "
            f"against one card's {want['param_bytes']} B: {r['param_bytes'] / want['param_bytes']:.3f}x")
    served = pp2["served"]
    log(f"train-pp2-serve: its --save-dir (the gathered one-card tree) served on one card in "
        f"{served['seconds']:.1f} s: action {np.round(served['action'][0], 4).tolist()}..., "
        f"K2 {served['launches']['int4_matmul']} a request")
    if served["launches"]["int4_matmul"] != TRAIN_K2_PER_STEP:
        raise RuntimeError(f"train-pp2-serve: K2 {served['launches']} a request")
    label = "train-sp2-qlora-w4a8"
    _check_ranks(label, sp2["ranks"], 3, {"int4_matmul": TRAIN_K2_PER_STEP}, want["losses"])
    for r in sp2["ranks"]:
        log(f"{label}: rank {r['rank']}: SigLIP rows a layer {sorted(set(r['rows']['siglip']))}, "
            f"vlm rows a layer {sorted(set(r['rows']['vlm']))} (of 256 patches and 276 tokens); "
            f"resident parameters and buffers {r['param_bytes'] / want['param_bytes']:.3f}x one "
            "card's")
        if set(r["rows"]["siglip"]) != {128} or set(r["rows"]["vlm"]) != {138}:
            raise RuntimeError(f"{label}: rank {r['rank']} took rows {r['rows']}")


def _serving_ranks(one_rank: dict) -> tuple:
    """In a child: phases 55-59 (each joins and leaves a process group in
    that process), against the one-process answers ``one_rank``. Returns
    (each phase's launches, every shape rank 0 gave K2, K1 (its masks as
    numpy arrays) and K3)."""
    ONE_RANK.update(one_rank)
    device = torch.device("cuda", 0)
    phases = (
        ("serve-tp2", lambda: served_tp2(device, "serve-tp2", "config/eval/bridge.yaml", "serve",
                                         {"flash_attention": 17})),
        ("serve-dp2", lambda: served_dp2(device)),
        ("serve-tp2-w4a8", lambda: served_tp2(
            device, "serve-tp2-w4a8", "config/eval/bridge_pool64_w4a8_steps1.yaml",
            "serve-w4a8", {"flash_attention": 17, "int4_matmul": W4A8_STEP_LAUNCHES})),
        ("serve-tp2-int8", lambda: served_tp2(
            device, "serve-tp2-int8", "config/eval/bridge_pool64_steps2.yaml", "serve-int8",
            {"flash_attention": 17, "int8_matmul": INT8_STEP_LAUNCHES}, cache_fp=False)),
        ("serve-tp2-openvla", lambda: served_tp2_openvla(device)),
    )
    launches = []
    with _RecordInt4Shapes() as int4, _RecordFlashShapes() as flash, \
            _RecordInt8Shapes() as int8:
        for label, phase in phases:
            t0 = time.monotonic()
            launches.append(phase())
            log(f"{label}: the phase took {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory(prefix="blurr_dp2_") as tmp:
            launches.append(openloop_dp2(device, tmp))
        log(f"openloop-dp2: the phase took {time.monotonic() - t0:.1f} s")
    # numpy: a torch tensor put on a queue is shared through this process,
    # which is gone by the time the parent reads it
    return launches, int4.seen, {k: m.cpu().numpy() for k, m in flash.seen.items()}, int8.seen


def _same_hashes_everywhere() -> None:
    """Run this script again with PYTHONHASHSEED=0 unless it is set. The stub
    tokenizers map words through Python's salted ``hash``, so without one
    seed a child process (the parallel phases' ranks, rank 0 included)
    tokenizes the same instruction into other ids than this process did
    for the one-process answers and losses it is held against."""
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.environ["PYTHONHASHSEED"] = "0"
        sys.stdout.flush()
        sys.stderr.flush()
        os.execv(sys.executable, [sys.executable, *sys.argv])


def main() -> int:
    from blurr_tpu_torch.presets import load_config

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a GPU",
              file=sys.stderr)
        return 1
    _same_hashes_everywhere()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.monotonic()

    def elapsed(phases: str) -> None:
        log(f"elapsed: phases {phases} done at {time.monotonic() - t_start:.1f} s")

    kind = probe()
    build()
    flash = kernel_vs_plain(device)
    kernel_text_vs_plain(device)
    int4 = int4_vs_plain(device)
    int8 = int8_vs_plain(device)
    tp2 = tp2_kernels_vs_plain(device)
    elapsed("1-3b, 54")
    server, cfg, image, proprio, launches, actions = served_control_steps(device)
    model_kernel_vs_plain(server, image, proprio)
    checkpoint_launches = served_checkpoint(device, server, cfg, actions)
    del server
    _free()
    elapsed("4-5e")
    batched_launches = served_batched(device)
    backpressure_launches = served_backpressure(device)
    small_model_vs_cpu(device)
    baseline_launches = served_baseline_steps(device)
    torch.cuda.empty_cache()
    elapsed("6-6b")
    small_model_vs_cpu(device, adaptive="adaLN-Zero")
    w4a8_launches = served_w4a8_steps(device)
    torch.cuda.empty_cache()
    batched_w4a8_launches = served_batched_w4a8(device)
    small_model_vs_cpu(device, "w4a8")
    int8_launches = served_int8_steps(device, cache_fp=False)
    torch.cuda.empty_cache()
    cached_launches = served_int8_steps(device, cache_fp=True)
    torch.cuda.empty_cache()
    small_model_vs_cpu(device, "int8")
    elapsed("4-11")
    experiments = experiments_vs_plain(device)
    torch.cuda.empty_cache()
    experiment_launches = experiments_run()
    torch.cuda.empty_cache()
    elapsed("12-13")
    with tempfile.TemporaryDirectory(prefix="blurr_eval_") as tmp:
        agent, eval_launches = eval_agent_blurr(device, tmp)
        frame_launches = from_frame(device, agent)
        async_launches = eval_agent_async(agent)
        del agent
        _free()
        eval_batched_launches = eval_agent_batched(device)
        _free()
        eval_w4a8_launches = eval_agent_w4a8(device, tmp)
        _free()
        elapsed("14-18")
        with _RecordInt4Shapes() as openloop_shapes, _RecordFlashShapes() as scored_flash:
            scored_launches = record_then_score(
                [(f"record-then-score-{kind}", os.path.join(tmp, f"recorded_{kind}"),
                  _recorded_examples(os.path.join(tmp, f"recorded_{kind}")))
                 for kind in ("serial", "async")])
    elapsed("47-48")
    eval_cli()
    small_agent_launches = small_agent_vs_cpu(device)
    _free()
    text_pi0_launches = text_pi0(device)
    text_paligemma_launches = text_paligemma(device)
    small_text_launches = small_text_vs_cpu(device)
    _free()
    elapsed("14-23")
    held = int4_openvla_vs_plain(device)
    with _RecordInt4Shapes() as served:
        openvla_runs = (served_openvla_7b(device), served_openvla_7b_w4a8(device),
                        served_openvla_7b_w8a8(device), served_openvla_oft(device),
                        served_minivla(device), openvla_snapshot(device),
                        served_openvla_batched(device))
        elapsed("24-30b")
        openvla_runs += (eval_hf_7b_w4a8(device), eval_hf_snapshot(device),
                         eval_prismatic(device))
        elapsed("32-34")
    jacobi_fp32(device)
    served_int4_vs_plain(device, served.seen, held)
    elapsed("24-35")
    small_train_vs_cpu(device)
    with tempfile.TemporaryDirectory(prefix="blurr_train_") as tmp:
        train_launches, trained, save_dir = train_qlora_w4a8(device, tmp, set())
        resume_launches = train_resume(device, tmp, trained.model)
        train_serve_launches = train_serve(device, save_dir, trained.model)
        del trained
        _free()
        full_launches = train_full(device, tmp)
    elapsed("36-40")
    with tempfile.TemporaryDirectory(prefix="blurr_vla_train_") as tmp:
        t0 = time.monotonic()
        vla_launches, vla_run, vla_shapes, params, data = train_openvla_qlora(device, tmp)
        vla_resume_launches = train_openvla_resume(device, tmp, data, vla_run.model)
        vla_serve_launches = train_openvla_serve(device, params, vla_run.model)
        del vla_run
        _free()
        oft_launches, oft_shapes = train_openvla_oft(device, tmp)
        served_int4_vs_plain(device, vla_shapes | oft_shapes, set(),
                             label="train-openvla-int4-shapes",
                             what="the OpenVLA training runs", by="an earlier phase",
                             exact=True)
        peft_launches = peft_roundtrip(device, tmp)
        eval_openloop_vla(data, params)
        log(f"openvla-training: the phases took {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    with _RecordInt4Shapes() as gptq_shapes, _RecordFlashShapes() as gptq_flash:
        openloop_launches = openloop_runs(device)
        gptq_launches = gptq_run(device)
        closed_loop_launches = closed_loop()
    flash_shapes_vs_plain(device, {**scored_flash.seen, **gptq_flash.seen})
    served_int4_vs_plain(device, openloop_shapes.seen | gptq_shapes.seen, set(),
                         label="openloop-int4-shapes",
                         what="the open-loop, GPTQ and closed-loop phases", by="an earlier phase",
                         exact=True)
    log(f"openloop-gptq: the phases took {time.monotonic() - t0:.1f} s")
    elapsed("36-53")
    # the ranks' phases come last, in child processes: this process joins
    # no process group. Phases 55-59 (one child) run beside 62-65
    t0 = time.monotonic()
    serving = _start_children([(_serving_ranks, (dict(ONE_RANK),), {})], deadline_s=900.0)
    try:
        with tempfile.TemporaryDirectory(prefix="blurr_train_ranks_") as tmp:
            data = os.path.join(tmp, "shards")
            _raw_shards(data, load_config("config/eval/bridge.yaml"))
            train_ranks_launches, train_shapes = parallel_training(data, tmp)
    except BaseException:
        for p, _ in serving[0]:  # no child outlives a failed run
            p.kill()
        raise
    log(f"parallel-training: phases 62-68 took {time.monotonic() - t0:.1f} s")
    ((ranks_runs, ranks_int4, ranks_flash, ranks_int8),) = _children_results(
        "parallel-serving", serving)
    log(f"parallel: the serving phases 55-59 (beside 62-68) took {time.monotonic() - t0:.1f} s")
    ranks_flash = {k: torch.from_numpy(m).to(device) for k, m in ranks_flash.items()}
    ranks_shapes_vs_plain(device, ranks_int4, ranks_flash, ranks_int8, tp2)
    profile_after_ranks(device)
    served_int4_vs_plain(device, train_shapes, set(), label="train-ranks-int4-shapes",
                         what="the ranks of phases 62-63 and 66-67", by="an earlier phase",
                         exact=True)
    elapsed("55-68")
    runs = (*ranks_runs, train_ranks_launches,
            launches, checkpoint_launches, batched_launches, backpressure_launches,
            baseline_launches, w4a8_launches, batched_w4a8_launches, int8_launches,
            cached_launches, experiment_launches, eval_launches, frame_launches,
            async_launches, eval_batched_launches, eval_w4a8_launches, small_agent_launches,
            text_pi0_launches, text_paligemma_launches, small_text_launches, *openvla_runs,
            train_launches, resume_launches, train_serve_launches, full_launches,
            vla_launches, vla_resume_launches, vla_serve_launches, oft_launches, peft_launches,
            *scored_launches, *openloop_launches, gptq_launches, closed_loop_launches)
    total = {name: sum(run[name] for run in runs) for name in KERNEL_NAMES}
    # K1, K2 and K3 at the shapes a rank of the tp=2 paths gives them
    measured = {"flash_attention": {**flash, "shapes_tp2": tp2["flash_attention"]},
                "int4_matmul": {**int4, "shapes_tp2": tp2["int4_matmul"],
                                "shapes_train_ranks": sorted(train_shapes)},
                "int8_matmul": {**int8, "shapes_tp2": tp2["int8_matmul"]},
                **experiments}
    # the TPU kernel each replaces (file:line of its kernel body); K2 also
    # replaces the bitcast int4 kernels of the experiments, at one group
    replaces = {
        "flash_attention": "blurr_tpu/ops/pallas_attention.py:40",
        "int4_matmul": "blurr_tpu/ops/pallas_int4_matmul.py:109",
        "int8_matmul": "blurr_tpu/ops/pallas_int8_matmul.py:30",
        "w8a8_matmul": "experiments/bench_pallas_int4.py:37",
        "int4_split_matmul": "experiments/bench_pallas_int4.py:42",
        "fused_ffn": "experiments/bench_fused_ffn.py:32",
    }
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"blurr_tpu_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": total[name], **measured[name]}
        for name in KERNEL_NAMES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
