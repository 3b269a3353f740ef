#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port
(``reinforcement_learning_in_music_generation_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and nvcc.  It
  1. builds every kernel of the generation, training, discriminator, DQN and
     PPO paths and the decode kernels v3, v1, v2 and v5 from ``csrc/`` (one
     nvcc per source, in parallel), prints each library's ptxas registers
     and spills, and the card's name and power limit;
  2. at the full width of ``config.agent_config`` (12 layers, d_model 512,
     8 heads, FFN 2048) with random weights from a seed, holds each kernel
     against its plain PyTorch version on the same inputs:
       decode_step (v4 counterpart), 16 teacher-forced steps at B=5 and
       B=128 (and B=5 with bf16 weights): max |h| difference <= 1e-3 with
       an f32 state (both sides accumulate in f32; only the summation order
       differs), and >= 99% greedy next-token agreement with the default
       bf16 state;
       decode_chunk (v6 counterpart), B=128, against its twin of v6's
       arithmetic, at f32 weights (f32-grade products: three bf16 planes an
       operand, six products) and bf16 weights (generate's default), both on
       the tensor cores: >= 99% teacher-forced greedy agreement with f32 and
       bf16 states (state difference <= 1e-4 of its magnitude with f32
       weights and state, 3e-4 with bf16 weights, each with a control that
       must end above it: the route on the weights rounded to bf16, and a
       state rounded to bf16); every call on the tensor-core route; chunk
       invariance at both weight types (64 tokens in one call equal 2 x 32,
       bit for bit); a greedy 128-token call (>= 95% of tokens equal with
       f32 weights: the fed-back streams part only after a near-tie;
       printed for bf16, where one comes within a few tokens); the HMMA/HGMMA
       count in the SASS of the route's product kernels at both weight types
       and of kernel E's three passes at every depth for f32 and bf16
       tensors (cuobjdump, > 0 in each); the SIMT
       heads + sample pass on fixed h against the plain version with the
       same seed (>= 99% of tokens equal: they differ only at near-ties);
  3. runs ``apps/cli.py generate`` end to end: 5 songs (the per-step v4
     path) and 128 songs (the chunked v6 path) with bf16 weights, its
     default, and 128 songs with ``--dtype float32``, checks the MIDI files
     and fails if the path's kernel was launched no time, or if a 128-song
     run's calls did not all reach kernel B's tensor-core route at 1 + T
     CUDA launches a call;
  4. holds the two training kernels against their plain versions at the
     pretrain slice's shapes (B=32 x S=512 rows, flagship width, f32,
     TF32 off): qkv_attention_block (kernel C) forward within 1e-4 of the
     output's magnitude and (dh, dWqkv, dbqkv) within 1e-3 of each
     gradient's; on bf16 tensors against its twin of JAX's bf16 arithmetic
     (f32 projection and attention, stores rounded), att and every
     gradient within C_BF16_GATES (max|diff| within BF16_TOL or less of
     its magnitude, mean|diff| within a small share of mean|ref|), with a
     control that must end above the mean limits: the kernel with its
     attention reading the rounded residual (the parent kernel's fault),
     and the parent's plain arithmetic (every product rounded to bf16)
     printed beside; HGMMA
     in the SASS of C's two projection kernels (cuobjdump, > 0 in each);
     attn_tail_block (kernel D) the same, at dropout 0 and 0.1
     (the plain version draws the same Philox bits), and on bf16 tensors
     against its twin of JAX's bf16 arithmetic, the output and every
     gradient within BF16_TOL (2^-7) of its magnitude; the HMMA count in
     the SASS of D's and G's product kernels (cuobjdump, > 0 in each);
  5. takes one full-width train step (dropout 0, same weights and batch)
     on the kernel route and on the plain route: losses within 1e-4
     relative, every gradient within 1e-3 of its leaf's magnitude, every
     parameter after the Adam update within 1e-4 of its magnitude, and the
     Adam updates themselves within 1e-3 of the leaf's largest update
     wherever the plain gradient's sign is settled (|g| above the gradient
     check's limit); then times two more steps of each;
 5b. takes the kernel route's step (C + D, dropout 0.1) with
     ``remat=True`` (each layer under torch.utils.checkpoint) and without,
     from the same generator seed, at f32 and bf16: losses and gradients
     under the checks of 5, the generator's state after the step equal, C's
     and D's forward counters at 2 x 12 (the recompute) and their backward
     at 12, the remat step's peak device memory below the other's; prints
     both peaks and ms a step;
  6. runs ``apps/cli.py pretrain`` for 4 steps at B=32, S=512 on each route,
     and on the kernel route with ``--dtype bfloat16`` (C and D on bf16
     tensors), and fails unless each training-kernel counter reads 12 x
     steps on the kernel route (0 on the plain one), C's attention runs as
     its passes count them the same, and every logged loss is finite; then
     ``--dtype bfloat16`` under RLMG_ATTN_BACKEND=pallas (kernel F on bf16
     tensors): F's counters and its own runs 48 + 48, the others 0, every
     loss finite, and the top five kinds of ``utils.summarize_trace`` over
     one profiled step (``utils.profile_trace``);
  7. holds kernel E (window_attention_band, the counterpart of
     window_attention_pallas) against its plain twin at the discriminator
     LM's shape (B=4, H=8, S=3584, D=64, window 512, f32) with the padding
     of synthetic_cp_dataset(4, 3584) (seed 0) and with a padding tail
     longer than w on every song: out and LSE within 1e-5 of their
     magnitude, dq / dk / dv (dO zero on padded rows, as the LM's masked
     loss gives) within 1e-4 of theirs, every value finite, with a control
     (the twin on q, k, v rounded to bf16, against the f32 twin) that must
     end above those gates; on bf16 tensors (synthetic padding) against
     its twin of JAX's bf16 arithmetic, out (kept rows) and the gradients
     within E_BF16_GATES (max|diff| within BF16_TOL of the magnitude,
     mean|diff| within a small share of mean|ref|), with a control that
     must end above the mean limits (the twin with P and dS rounded to bf16
     before their products); and exactly: the bf16 out and gradients equal,
     bit for bit, E's f32 route on the widened operands (the stored bf16
     out handed to its backward), rounded to bf16, where the same control
     must differ (a dropped plane of an f32 operand); the library yardstick
     (scaled_dot_product_attention with the additive band mask) within
     1e-4 on the rows that see a kept key;
  8. holds kernel D at the Longformer's shape (14336 rows, d_model 512,
     d_inner 1024, mid_drop=False) against its plain version at dropout 0
     and 0.1, forward and the 12 gradients, f32 and bf16 as in 4;
  9. takes one discriminator-LM step (discrim_lm_config at full width,
     B=4 x S=3584, dropout 0, same weights and batch) on three routes:
     default (kernel D + the plain band attention), RLMG_WINDOW_BACKEND=
     pallas (kernel E + the plain tail) and all plain (RLMG_FFN_BACKEND=
     xla); each kernel route against the plain one with the checks of 5,
     counters 12 + 12 for its kernel and 0 for the other; then times two
     more steps of each; and one step with the parameters in bf16 under
     RLMG_WINDOW_BACKEND=pallas (kernel E on bf16 tensors): finite loss and
     gradients, E's counters 12 + 12;
 10. runs ``apps/cli.py discrim-pretrain`` for 4 steps at B=4, S=3584 on
     the default route and under RLMG_WINDOW_BACKEND=pallas and fails
     unless the route's kernel counters read 12 x 4 and every logged loss
     is finite;
 11. holds kernel F (causal_product, the counterpart of the Pallas causal
     linear-attention product _fwd_pallas / _bwd_pallas) against its plain
     twin at (1, 8, 50, 64) (a rollout episode), (30, 8, 50, 64) (a DQN
     update), (32, 8, 512, 64) (pretrain), a ragged (4, 8, 300, 64) and the
     tile edge (4, 8, 64, 64), (4, 8, 65, 64), f32, in the model's layout
     (views of (B, S, H, E) tensors): out and den within 1e-4 of their
     magnitude, dq / dk / dv within 1e-3 of theirs; F's runs as the kernel
     counts them equal the wrapper's calls; two backward runs bit-equal at
     the DQN, ragged and pretrain shapes; on bf16 tensors at the rollout,
     ragged and pretrain shapes against its twin of JAX's bf16 arithmetic,
     out, den and the gradients within F_BF16_GATES (as E's), with two
     controls that must end above the mean limits (the chunked composition
     in bf16 arithmetic; for the gradients F's f32 route with den
     unrounded), the bf16 out and den equal, bit for bit, F's f32 route on
     the widened inputs, rounded, where a control (the twin with A and the
     state rounded: a dropped plane of each) must differ; two bf16 backward
     runs bit-equal; float64 inputs and heads of 72 refused;
 12. takes one full-width DQN update (agent_config, dropout 0, lr 1e-4,
     B=30 x S=50, the same weights and batches) on the default route (the
     plain composition) and under RLMG_ATTN_BACKEND=pallas (kernel F): mse
     and ce within 1e-4 relative, gradients, parameters and Adam updates as
     in 5; F's counters 3 x 12 forward and 2 x 12 backward (eval, target,
     CE; no backward through the target) and 0 on the default route;
     choose_action on 50 states equal in >= 99% of the action fields across
     routes; then times two more updates of each; then (12b) on each route
     4 rollout songs (50 episodes) as graph replays (one an episode) and as
     the eager loop, states, actions and next states bit-equal, again after
     one in-place DQN update, with ms per song, host launches and the busy
     share of one song's window of each; one capture a route; F's own runs
     12 x 50 x 12 + 36 forward and 24 backward, the wrapper's counts its
     eager calls only (the capture's first episode, the eager songs and the
     update);
 13. takes one AIRL disc_step and scores 500 states at full width (10
     layers, window 50, B=100 x S=50): finite losses and scores; times the
     step and the scoring pass;
 14. runs ``apps/cli.py dqn-train`` (batch 30, buffer 500, 12 songs, 2
     updates) on both routes: 2 updates, the checkpoints and
     agent_info.pickle written, every printed loss and score finite, F's
     own runs 12 x (50 x 12 + 3 x 2) = 7272 forward and 12 x 2 x 2 = 48
     backward under RLMG_ATTN_BACKEND=pallas and 0 on the default route,
     the wrapper's counts the eager calls (12 a capture and the updates'
     72 + 48); the median ms per rollout song after the
     first (graph replays) at most a third of phase 12b's eager loop's on
     each route; prints ms per rollout song, per DQN update and per AIRL
     pass;
 15. runs ``apps/cli.py pretrain`` 4 steps at B=32 x S=512 under
     RLMG_ATTN_BACKEND=pallas: F's counters 48 + 48 and its own runs the
     same, C's and D's 0, every loss finite;
 16. holds kernel G (ffn_block, the counterpart of the Pallas ffn_block)
     against its plain twin at 50 rows (a rollout state), 100 (ragged),
     1500 (a PPO update) and 16384 (pretrain), d_model 512, FFN 2048, f32,
     dropout 0 and 0.1: out within 1e-4 of its magnitude, the seven
     gradients within 1e-3 of theirs; on bf16 tensors within BF16_TOL as in
     4; two backward runs bit-equal at both dtypes; d_model 1028 refused;
 17. one full-width PPO rollout song and update step (actor_config and
     critic_config at 12 layers, the reward ppo_reward_config at 10, dropout
     0, lr 1e-4, 30 episodes of 50-state windows) on the default route and
     under RLMG_FFN_BACKEND=pallas (kernel G): G's own forward runs 30 x 24
     in the graphed rollout (the wrapper's count 24, the capture's first
     episode) and the wrapper's 36 + 36 in the update (0 on the default
     route);
     choose_action on 50 states equal in >= 99% of the action fields; the
     rollout's values and rewards within 1e-4; the losses within 1e-4
     relative, gradients, parameters and Adam updates of both trees as in
     5; then times two more steps of each; then (17b) on each route 4
     rollout songs as graph replays and as the eager loop: states and
     actions bit-equal, log-probs, values and rewards within 1e-6 of their
     magnitude, again after one in-place update step, with ms per song, host
     launches and busy share; one capture a route; G's own forward runs
     those of every episode and the update, the wrapper's its eager calls;
 18. runs ``apps/cli.py ppo-train`` (2 songs, 30 episodes, 50 states, 25
     actions, 10 PPO steps) on both routes: ppo_best.ckpt written, every
     printed loss and reward finite, G's own forward runs 2 x 1080 and the
     wrapper's 2 x 360 backward under the knob and 0 on the default route,
     the wrapper's forward count its eager calls (24 a capture and the
     updates' 2 x 360); the second rollout song (graph replays) at most
     a third of phase 17b's eager median; prints ms per rollout song and
     per update_policy;
 19. runs ``apps/cli.py pretrain`` 4 steps at B=32 x S=512 under
     RLMG_FFN_BACKEND=pallas (dropout 0.1): G's counters 48 + 48 (its own
     forward runs 48), C's, D's and F's 0, every loss finite;
 20. runs ``apps/cli.py inference`` (the actor at full width, 150 tokens)
     and checks the MIDI file holds 150 notes;
 21. holds the latency kernels (csrc/latency_decode.cu: v8, one launch a
     chunk, and v7, a graph of L + 2 launches a token) against their plain
     twin (``latency_decode_plain``: JAX v8's bf16 rounding of the product
     inputs and the embedding rows) at B=1, 5 and 16, 32 teacher-forced
     tokens, greedy and CP sampling with one seed: >= 99% of the tokens
     equal, with f32 weights and state (state within 1e-4 of its
     magnitude), bf16 weights and f32 state (within 3e-4 of max|S|, kernel
     B's gate) and bf16 weights and state; v7 and v8 bit-equal there and on
     whole 32-token calls; v8's 64 tokens in one call equal 2 x 32; a batch
     of 17 refused;
 22. runs ``apps/cli.py generate`` (8 bars, the bf16 default) with 1 and 5
     songs on the per-step path and under RLMG_LATENCY_DECODE=1 on v8 and
     (RLMG_LATENCY_KERNEL=v7) v7: MIDI files and runtime_stats.json
     written, only the route's kernel launched, at most 4 L + 2 grid
     barriers a token position as the kernels count them, and at most one
     v7 token graph instantiated in a run's calls; prints tokens/s of each;
 23. generates 64 tokens after a 100-token prompt (the parallel prefill)
     on the per-step (5 songs), chunked (128) and v8 (5) paths, and holds
     forward_prefill's state against 100 decode steps (1e-3 of magnitude);
 24. counts HMMA in the SASS of the bf16-weight latency kernels (> 0 in
     each), and times v8, v7, the plain twin and kernel A per token at B=1,
     5 and 16 (bf16 weights and state) beside the bound, with the grid
     barriers a token the kernels counted (at most 4 L + 2) and the CUDA
     launches a token;
 25. holds v3 (csrc/decode_aug.cu) against its plain twin at full width,
     8 heads of 64 at B=5 and 32 and one head of 512 at B=5, f32 and bf16
     weights, f32 augmented state, 32 teacher-forced tokens: h and the
     state within 1e-4 of their magnitude with f32 weights, >= 99% greedy
     agreement with bf16;
 26. the odd-head path end to end: ``generate_songs`` with agent_config at
     one head of 512 (5 songs, 8 bars, CP sampling, bf16, the default env)
     reaches v3 and never kernel A, every token in its vocabulary; tokens/s
     printed beside kernel A's at 8 heads;
 27. v1 and v2 (A's token kernel a layer, the tanh gelu; v1 with its LN1
     order) through ``fused_decode_step`` at full width, B=32, 16 tokens,
     f32: h and state within 1e-4 of their magnitude against the plain
     twins, one wrapper call a layer, one CUDA launch a call and one a
     layer's packing, the kernel's runs one a call, each variant's counted
     apart; each variant's h gate (rtol = atol = 1e-4) against the exact
     gelu at f32 and bf16 layers (``control_gate_failures``: the variant
     within it, the same tokens with each layer on v3's token kernel above
     it);
 28. v5 (csrc/latency_decode.cu): its main path, the parity (B=8, T=64,
     bf16 and f32 weights) and perf (B=256, T=128, bb 8, 16, 32) modes of
     scripts/profile_torch_decode_v5.py, launches the kernel, every token in
     range, the f32 greedy stream >= 99% equal to the per-step path's (the
     bf16 one is printed: that reference rounds its activations to bf16);
     against its plain twin at B=8, bf16 and f32 weights, 64 one-token
     calls each from the twin's state, greedy and CP sampling with one
     seed: >= 99% of the tokens equal, and after the same 64 fed tokens the
     states within 1e-3 of their magnitude; HMMA in both instantiations of
     v5's kernel and of v1's and v2's token kernel (cuobjdump); bb=16 at B=8
     refused;
 29. times v3 (B=5 at one head; B=5, 32, 128 at 8 heads), v1 and v2 (one
     layer, B=32, through the wrapper and on the device) and v5 (B=8; B=256
     at bb 8, 16, 32) beside their plain twins, kernel A (and v8) at the
     same B, the launches a token read from the counters and the bound
     (operations at the bf16 peak for v5, at 989/6 for v1's and v2's
     f32-grade products);
 30. times each kernel and its plain version at the main paths' shapes
     (CUDA events) beside the least time the card could take, and kernel E
     beside the library call (and its device time under the profiler);
     kernel B at B=128 and 1024 (T=128) at both weight types, with the
     state-streaming floor and the CUDA launches a call (1 + T); B with f32
     weights and E bounded at 989/6 TFLOP/s (their f32-grade products on
     the tensor cores), the f32 FMA bound beside;
     kernel C (16384 rows) at f32 and bf16 through the wrapper, and its
     projection and attention passes alone (events and device time), each
     bounded at its route's rate (the projection 989 TFLOP/s for bf16
     tensors, 989/6 for f32; the attention's f32-grade products 989/6),
     the f32 FMA bound beside;
     kernels D (16384 and 14336 rows) and G (50, 1500, 16384 rows) at f32
     and bf16 with the CUDA launches a call, bounded at the rate of their
     tensor-core arithmetic (bf16 989 TFLOP/s; f32 tensors 989/6, six bf16
     products a product), the f32 FMA bound beside; kernel F at the
     rollout, DQN-update and pretrain shapes through the wrapper, on the
     card alone (profiler) and back to back (the host's pace), bounded at
     989/6 TFLOP/s with the f32 FMA bound beside; F on bf16 tensors at the
     rollout, ragged and pretrain shapes and E on bf16 tensors at the
     discriminator's (SDPA on the same bf16 tensors beside), bounded at
     bf16 bytes and the bf16 peak, the rate of their f32-grade products
     beside, with the card's name and power limit;
 31. the continuous batcher (``generate/serving.py``, kernel A, one CUDA
     graph replay a step) at agent_config: 24 songs of 8 bars on 8 slots,
     f32 weights (``serve``'s default) and bf16 (``generate``'s): the
     graphed loop's songs, steps and songs_done equal the eager loop's on
     the same generator; every song has 8 bars and starts with CP_SEED;
     every slot refilled at least once; each refilled slot's (s, z) rows
     equal those of its song teacher-forced from a zero state through
     kernel A in the slot's row of a batch of 8 (within 1e-3 of their
     magnitude; bit-equality printed, and the share alone at batch 1);
     kernel A's runs, as the kernel counts them, equal the replays plus the
     eager calls; prints tokens/s, the steps against synchronous batching of
     the same 24 songs (and generate_songs run in three batches of 8) and
     the refill's share of a replay;
 32. ``apps/cli.py generate --continuous`` (24 songs, 8 slots, 8 bars) and
     ``generate --prompt`` on a MIDI file written from a generated song at
     5 songs (kernel A) and 128 (kernel B), the prompt taking the parallel
     prefill: the MIDI files, every prompted song starting with the prompt
     with the bars asked, and the path's kernel launched;
 33. ``apps/cli.py serve`` on a request file (an unconditional request, a
     prompt request, one without an id, a shutdown line): responses.jsonl,
     the MIDI files and the journal; then a request appended after the
     shutdown and the daemon restarted on the same file serves only it;
     prints the requests served a second.
 34. data parallelism, two ranks on the one card (``parallel.launch``, gloo
     over CUDA tensors: NCCL refuses two ranks on one card, and make_mesh
     must refuse them unless backend="gloo" is passed), at agent_config, B=32
     x S=512 global, the second half's rows masked after 100 positions (the
     ranks' mask sums differ): one f32 step at dropout 0 with ``dp_mesh`` on
     each rank's 16 x 512 rows, C and D launched 12 times forward and
     backward on each rank (E, F, G none); the loss, gradients, parameters
     and Adam updates within phase 5's step gates of the same step in one
     process on the whole batch, and the control, the Adam step of the mean
     of the ranks' own means, outside them; the ranks' parameters after the
     step bit-equal; one bf16 step at dropout 0.1 (a finite loss, equal on
     both ranks, C and D counted), and kernel D's outputs on equal inputs
     from equal generator states different on the two ranks (seeds 7919
     apart) and equal without the mesh; prints ms a step on each rank and
     in one process, and the gradients' all-reduce;
 35. ``generate_songs(mesh=...)`` on 8 songs with bf16 weights, greedy under
     RLMG_FUSED_DECODE=1 RLMG_FUSED_SAMPLING=1 (kernel A, one graph replay a
     token): the tokens equal one process's on the same 8 songs, kernel A's
     runs counted on both ranks; a stochastic run's 8 songs valid, the same
     list on both ranks, and no song of rank 0 a copy of one of rank 1;
     prints ms on the ranks and in one process.
 36-38. tensor parallelism (``tp_run``): the tp step at tp = 2 and dp = 2 x
     tp = 2 against one process, kernel F on each rank's heads, a control;
     greedy songs under tp.
 39. the RL steps on dp = 1 x tp = 2 (``rl_run`` -> ``rl_rank``, two gloo
     ranks on card 0, RLMG_ATTN_BACKEND=pallas RLMG_WINDOW_BACKEND=pallas,
     flagship width, dropout 0, lr 1e-4): one dqn.update on 30 x 50 (kernel
     F's own runs 36 + 24 a rank on (30, 4, 50, 64)), one AIRL disc_step on
     100 x 50 (the dense band: E none) and on 4 x 2048 (E 30 + 30 a rank on
     (4, 4, 2048, 64)), each within the loss and gradient gates of the same
     step in one process; one DQN rollout song (50 episodes, eager under tp,
     F 600 runs a rank on (1, 4, 50, 64)) whose actions equal one
     process's, a difference passing only at a near-tie (one process's
     top-2 margin under 1e-3, printed); the ranks' parameters bit-equal;
 40. dp = 2 x tp = 2, four ranks: a PPO rollout song (actions equal one
     process's, values, rewards and log-probs within 1e-4 of their
     magnitude) and one update_policy_step on its transitions split over
     dp, the DQN update and the discriminator step, against one process;
     control (i), each rank's own MSE mean summed over dp, must end outside
     the gates; the dp ranks' actor, critic, agent and discriminator
     parameters bit-equal;
 40b. dp = 2 x tp = 1, two ranks, under RLMG_FFN_BACKEND=pallas as well: a
     DQN rollout song and a PPO rollout song, each graphed on every rank
     (one capture, then a replay an episode), the DQN update and one
     update_policy_step on each dp rank's rows, against one process;
     kernels F and G counted on every rank (G at tp = 1 only), the ranks'
     parameters bit-equal;
 41. ``cli dqn-train --tp 2`` and ``cli ppo-train --dp 2 --tp 2`` (4 layers)
     on gloo ranks sharing card 0, through ``apps/cli.py``'s rank entry:
     finite metrics, two DQN updates, the ranks' parameters and generator
     equal, the checkpoints whole, F run on every rank; ms per rollout song
     and update beside one process's with the same flags; prints the three
     phases' time.
 42. sequence parallelism (``sp_run`` -> ``sp_rank``, two gloo ranks on card
     0): q, k, v (32, 8, 512, 64) f32 split over sp = 2, each rank's half
     through ``causal_linear_attention_sp(backend="pallas")`` forward and
     backward (kernel F on (32, 8, 256, 64), its den cotangent added
     outside it): F's calls and own runs 1 + 1 on each rank; the gathered
     out and dq / dk / dv within phase 11's F gates of one process's
     kernel-F call on the whole sequence; the controls (an inclusive
     prefix; a gather whose backward keeps the rank's own cotangent) outside
     them; ms a call on the ranks beside one process's.
 43. pipeline parallelism (``pp_run`` -> ``pp_rank``, gloo ranks on card 0,
     agent_config, B=32 x S=512, dropout 0, RLMG_FFN_BACKEND=pallas-tail):
     one pipeline step (m = 2 pp microbatches, the GPipe backward, Adam with
     the clip by the whole gradient's norm) at pp = 2 and at dp = 2 x pp = 2:
     kernel D 12 / pp x m times forward and backward on every stage, no
     other kernel; within phase 36's step gates of one process's
     agent_train_step on the same route; the replicated leaves bit-equal on
     every rank; the control (the heads' gradients counted pp times) outside
     the gates; at pp = 2 the same step under RLMG_FFN_BACKEND=pallas
     (kernel G 12 / pp x m times on every stage, the same gates) and one
     dropout-0.1 step at f32 and at bf16 (finite losses, equal on the
     ranks); ms a step beside one process's.
 44. ``cli pretrain --pp 2 --dp 2`` (4 layers, one 8 x 512 batch) on gloo
     ranks sharing card 0: finite losses, a whole-tree checkpoint from rank
     0, and ``cli pretrain`` at pp 1 resuming from it.
It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # f32 FMA outside the tensor cores
BF16_FLOPS = 989e12            # bf16 products with f32 sums, tensor cores, dense
# kernels D and G on f32 tensors: each product as six bf16 products (the
# operands split into three bf16 planes) on the tensor cores
SPLIT_BF16_FLOPS = BF16_FLOPS / 6
# kernel A and v3 with bf16 weights: each product as three bf16 products
# (the f32 activations split into three planes, the weight exact in one)
SPLIT3_BF16_FLOPS = BF16_FLOPS / 3
# kernels D and G on bf16 tensors against their twins: every tensor within
# this share of its magnitude, twice the bf16 rounding step (2^-8) at it
BF16_TOL = 2 ** -7
# kernel C on bf16 tensors against its twin of JAX's arithmetic, per
# tensor: (max|diff| / magnitude, mean|diff| / mean|ref|).  The kernel and
# the twin round the same f32 values on store, so they differ only where
# their f32 sums straddle a rounding boundary: a few elements, one bf16
# step each.  A kernel that attends on the rounded residual (the fault
# of C's earlier kernel; qkv_rounded_control puts it back) moves most
# elements: its mean share ends above these limits, which
# qkv_bf16_gate_failures checks.  The max share cannot tell the two apart
# (one step at the largest value is up to 2^-7 of it, and the fault's
# largest difference is often that same step), so it stays at BF16_TOL.
# The mean limits sit between the card's readings (NVIDIA H100 80GB HBM3,
# 700 W; the pretrain shape at three seeds and the card tests' four bf16
# shapes): the kernel's largest mean share att 8.9e-7, dh 1.32e-4, dWqkv
# 8.8e-5, dbqkv 2.7e-5; the control's least 1.40e-3, 9.4e-4, 9.8e-4,
# 2.3e-4 (PERF.md).
C_BF16_GATES = {"att": (BF16_TOL, 3e-5), "dh": (BF16_TOL, 3.5e-4),
                "dWqkv": (BF16_TOL, 3e-4), "dbqkv": (BF16_TOL, 8e-5)}
# kernels F and E on bf16 tensors against their twins of JAX's bf16
# arithmetic, per tensor, as C_BF16_GATES: both sides widen the bf16 inputs
# to f32, form every product at f32 grade and round the same f32 values on
# store (F also den, and dnum / dd in bf16 arithmetic from the rounded out
# and den), so they differ only where a sum in another order straddles a
# rounding boundary.  The controls (product_bf16_readings: the chunked
# composition in bf16 arithmetic, and F's f32 route with den unrounded for
# the gradients; band_rounded_control: P and dS rounded before their
# products) round elsewhere and must end above the mean limits.  A den that
# the two sides round differently (a sum straddling a boundary) moves that
# row's dnum, so F's gradients flip more often than its out.  The limits sit
# between the card's readings (NVIDIA H100 80GB HBM3, 700 W; phases 7 and
# 11 and the card tests test_causal_product_bf16_kernel_holds_its_gates and
# test_window_attention_bf16_kernel_holds_its_gates, F at ten shapes from
# (1, 8, 50, 64) to (32, 8, 512, 64), E at five up to the discriminator's):
# the kernels' largest mean share F out 2.3e-7, den 2.1e-6, dq 4.9e-6, dk
# 1.8e-5, dv 1.6e-5, E out 4.8e-7, gradients 3.8e-6; the controls' least F
# out 2.4e-3, den 1.1e-4, dq 6.1e-3, dk 2.5e-3, dv 2.1e-3, E 1.5e-3 (PERF.md).
F_BF16_GATES = {"out": (BF16_TOL, 3e-5), "den": (BF16_TOL, 2e-5), "dq": (BF16_TOL, 2e-4),
                "dk": (BF16_TOL, 2e-4), "dv": (BF16_TOL, 2e-4)}
E_BF16_GATES = {"out": (BF16_TOL, 3e-5), "dq": (BF16_TOL, 1e-4), "dk": (BF16_TOL, 1e-4),
                "dv": (BF16_TOL, 1e-4)}
# kernel B's tensor-core route with an f32 state: max|dS| against its twin,
# as a share of max|S|, after 16 teacher-forced tokens at the main path's shape
S_TC_TOL = 3e-4
FIELDS = 6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """The card's ms a call of ``fn``, whose call launches each of its
    kernels once: the sum over its kernels of each one's mean time under
    torch.profiler, over ``reps`` calls after a warm one (the host's pace
    does not enter; a mean per kernel, as the profiler may not keep every
    record of a window); CUDA events over back-to-back calls when it keeps
    no device time at all."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = sum(ev.self_device_time_total / ev.count for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count) / 1e3
    if ms == 0:       # no device record kept: CUDA events over back-to-back calls instead
        print("[time] the profiler kept no device time for this window: CUDA events instead",
              flush=True)
        return time_ms(fn, reps)
    return ms


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS):
    """(least ms, what binds) of a function that moves ``nbytes`` and does
    ``flops`` operations at the card's peak for their type: ``BF16_FLOPS``
    where the function's products take bf16 inputs (v5, v7 and v8 cast the
    activations to the bf16 weights' type; D and G on bf16 tensors),
    ``SPLIT_BF16_FLOPS`` for D and G on f32 tensors (six bf16 products a
    product), else f32 outside the tensor cores."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def mma_counts(sass: str, marker: str) -> dict:
    """{function: number of HMMA / HGMMA instructions} over the functions
    of a ``cuobjdump -sass`` listing whose name contains ``marker``."""
    fn, counts = None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if marker in m.group(1) else None
            if fn:
                counts.setdefault(fn, 0)
        elif fn and re.search(r"\bH(G)?MMA\b", line):
            counts[fn] += 1
    return counts


def cuobjdump_path():
    """The toolkit's cuobjdump, else the one Triton ships, else None."""
    cands = [shutil.which("cuobjdump"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")]
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                                  "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if c and os.path.exists(c)), None)


def kernel_union_ms(prof) -> float:
    """Length of the union of the device kernels' intervals of a
    torch.profiler run (its Chrome trace), in ms."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel" and "dur" in e)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def token_graph_window(sampler, params, cfg, dev, b=5, steps=64) -> dict:
    """A warm window of the per-step path's token graph under torch.profiler:
    ``generate_tokens(fused, fused_sampling)`` at b songs for ``steps``
    tokens (one eager prompt step, then a graph replay a token), after one
    untraced call that captures the graph.  Returns the wall and device
    times, the busy share (the kernels' union over the wall), the host's
    launch calls (runtime or driver launches and graph launches, counted by
    the profiler) a token, the replays and the captures in the window, and
    the runs of the token kernel (A, or v3 at odd heads) as the kernel counts
    them beside the wrapper's eager launches; and the device memory the
    untraced call left allocated, which its cached token graph holds (its
    weights, buffers and graph pool), when that call captured."""
    from reinforcement_learning_in_music_generation_torch.ops import (
        decode_kernel_v3 as dk3, decode_kernel_v4 as dk4)
    kern = dk4 if cfg.n_head % 2 == 0 else dk3
    init = torch.tensor([[sampler.CP_SEED]], dtype=torch.int32,
                        device=dev).expand(b, 1, FIELDS).contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def run():
        return sampler.generate_tokens(params, cfg, init, generator=gen, max_tokens=steps,
                                       fused=True, fused_sampling=True)

    torch.cuda.synchronize()
    m0, c0 = torch.cuda.memory_allocated(), sampler.generate_tokens.graph_captures
    run()
    torch.cuda.synchronize()
    held = (torch.cuda.memory_allocated() - m0
            if sampler.generate_tokens.graph_captures > c0 else None)
    r0, c0 = sampler.generate_tokens.graph_replays, sampler.generate_tokens.graph_captures
    kern.kernel_runs(reset=True)
    eager0 = kern.fused_stack_step.launches
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    host = {ev.key: ev.count for ev in ka if ev.device_type == torch.autograd.DeviceType.CPU
            and re.match(r"cu(da)?(Graph)?Launch", ev.key)}
    dev_ms = sum(ev.self_device_time_total for ev in ka
                 if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    kernels = sum(ev.count for ev in ka if ev.device_type == torch.autograd.DeviceType.CUDA)
    union = kernel_union_ms(prof)
    tokens = steps + 1
    return dict(wall_ms=wall, device_ms=dev_ms, union_ms=union, busy=union / wall,
                device_kernels=kernels, host_launches=sum(host.values()),
                host_launches_per_token=sum(host.values()) / tokens, host_calls=host,
                replays=sampler.generate_tokens.graph_replays - r0,
                captures=sampler.generate_tokens.graph_captures - c0, tokens=tokens,
                kernel_runs=kern.kernel_runs(),
                eager_launches=kern.fused_stack_step.launches - eager0, graph_bytes=held)


def rollout_window(run) -> dict:
    """One call of ``run`` (a rollout song) under torch.profiler: the wall
    ms, the kernels' union ms, the busy share (union / wall) and the host's
    launch calls (runtime or driver kernel launches and graph launches).
    The CUDA activity alone: it records the runtime's launch calls and the
    kernels, and not the CPU operators, whose 10^5 events in an eager song
    took the profiler 30 s to parse and added half the song's wall (the
    same launch counts and union either way, one DQN song on the card)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    host = {ev.key: ev.count for ev in ka if ev.device_type == torch.autograd.DeviceType.CPU
            and re.match(r"cu(da)?(Graph)?Launch", ev.key)}
    union = kernel_union_ms(prof)
    return dict(wall_ms=wall, union_ms=union, busy=union / wall,
                host_launches=sum(host.values()), host_calls=host)


def compare_rollouts(tag, rollout, songs, update, exact_keys, close_keys):
    """``rollout(song, graph)`` of each song graphed (a replay an episode)
    and eager: the keys ``exact_keys`` bit-equal, ``close_keys`` within
    1e-6 of their magnitude; then ``update()`` (an in-place optimizer step
    on the rollout's weights) and one song again.  Returns the ms per song
    of each (the first graphed song pays the capture) and one song's
    profiler window of each."""
    ms = {True: [], False: []}
    out = {}
    for i in range(songs):
        for graph in (True, False):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out[graph] = rollout(i, graph)
            torch.cuda.synchronize()
            ms[graph].append((time.perf_counter() - t) * 1e3)
        worst = 0.0
        for k in exact_keys:
            check(torch.equal(out[True][k], out[False][k]),
                  f"{tag}: song {i}: graphed {k} differs from the eager loop's")
        for k in close_keys:
            e = max_err(out[True][k], out[False][k])
            worst = max(worst, e / magnitude(out[False][k]))
            check(e <= 1e-6 * magnitude(out[False][k]), f"{tag}: song {i}: {k} differs by {e}")
        print(f"[{tag}] song {i}: graphed {ms[True][-1]:.1f} ms, eager {ms[False][-1]:.1f} ms; "
              f"{', '.join(exact_keys)} bit-equal; {', '.join(close_keys) or 'nothing else'} "
              f"within {worst:.3e} of their magnitude", flush=True)
    update()
    g, e = rollout(0, True), rollout(0, False)
    same = all(torch.equal(g[k], e[k]) for k in exact_keys) and all(
        max_err(g[k], e[k]) <= 1e-6 * magnitude(e[k]) for k in close_keys)
    print(f"[{tag}] after an in-place update of the weights: the replay "
          f"{'equals' if same else 'DIFFERS FROM'} the eager loop", flush=True)
    check(same, f"{tag}: after an in-place update the replay differs from the eager loop")
    win = {graph: rollout_window(lambda: rollout(1, graph)) for graph in (True, False)}
    med = {graph: sorted(v[1:])[len(v[1:]) // 2] for graph, v in ms.items()}
    for graph in (True, False):
        w = win[graph]
        print(f"[{tag}] {'graphed' if graph else 'eager'}: median ms per song after the first "
              f"{med[graph]:.2f} (first {ms[graph][0]:.1f}); one song under the profiler: wall "
              f"{w['wall_ms']:.2f} ms, kernels' union {w['union_ms']:.2f} ms, busy "
              f"{w['busy']:.1%}, {w['host_launches']} host launches {w['host_calls']}",
              flush=True)
    return dict(ms_graphed=ms[True], ms_eager=ms[False], median_graphed=med[True],
                median_eager=med[False], window_graphed=win[True], window_eager=win[False])


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def magnitude(t) -> float:
    return max(1.0, t.float().abs().max().item())


def gate_excess(x, ref, rtol: float, atol: float) -> float:
    """max |x - ref| / (atol + rtol |ref|): at most 1 where
    torch.testing.assert_close(x, ref, rtol=rtol, atol=atol) passes."""
    x, ref = x.float(), ref.float()
    return ((x - ref).abs() / (atol + rtol * ref.abs())).max().item()


def control_gate_failures(tag: str, kernel: float, control: float) -> list:
    """A gate's readings as multiples of it (``gate_excess``): the kernel
    within the gate, and a control that computes something else (v2's layer
    on the exact gelu) above it, else the gate is blind to that fault."""
    fails = []
    if not kernel <= 1.0:
        fails.append(f"{tag}: the kernel at {kernel:.3g} of the gate")
    if not control > 1.0:
        fails.append(f"{tag}: the control at {control:.3g} of the gate: the gate is blind to it")
    return fails


def named_leaves(tree, prefix=""):
    """{"/layers/wq/w": detached copy, ...} of a nested dict of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(named_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().clone()}


def fwd_bwd(fn, inputs, g):
    """fn's output and the gradients of <output, g> w.r.t. every input."""
    ts = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ts)
    return out.detach(), torch.autograd.grad(out, ts, g)


def time_fwd_bwd(fn, inputs, g, reps: int):
    """(forward ms, backward ms): the forward without autograd, the
    backward of one retained graph."""
    with torch.no_grad():
        f_ms = time_ms(lambda: fn(*inputs), reps)
    ts = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ts)
    b_ms = time_ms(lambda: torch.autograd.grad(out, ts, g, retain_graph=True), reps)
    return f_ms, b_ms


def fused_times(tag, kernel, plain, inputs, g, reps, work, counted) -> dict:
    """Kernel D or G (``kernel``; ``counted``: its wrapper, whose
    ``cuda_launches`` counts) beside its twin ``plain`` on ``inputs`` and the
    upstream gradient g, in their dtype: CUDA-event ms forward and backward,
    CUDA launches a call, and bounds from ``work(bytes an element)`` at the
    rate of the route's arithmetic (bf16 tensors BF16_FLOPS, f32 tensors
    SPLIT_BF16_FLOPS), with the f32 FMA bound of earlier PRs beside them."""
    dt = inputs[0].dtype
    rate = BF16_FLOPS if dt == torch.bfloat16 else SPLIT_BF16_FLOPS
    ts = [t.detach().clone().requires_grad_(True) for t in inputs]
    c0 = counted.cuda_launches
    out = kernel(*ts)
    c1 = counted.cuda_launches
    torch.autograd.grad(out, ts, g)
    n_fwd, n_bwd = c1 - c0, counted.cuda_launches - c1
    del out, ts
    k_f, k_b = time_fwd_bwd(kernel, inputs, g, reps)
    p_f, p_b = time_fwd_bwd(plain, inputs, g, max(3, reps // 5))
    (f_ops, f_b), (b_ops, b_b) = work(inputs[0].element_size())
    (bf, bfby), (bb, bbby) = bound(f_b, f_ops, rate), bound(b_b, b_ops, rate)
    fma_f, fma_b = bound(f_b, f_ops)[0], bound(b_b, b_ops)[0]
    recompute = bound(0, f_ops, rate)[0]
    print(f"[time] {tag} {str(dt)[6:]}: forward {k_f:.4f} ms (plain {p_f:.4f}, bound {bf:.4f} "
          f"{bfby}, f32 FMA bound {fma_f:.4f}; {f_ops / 1e9:.3f} GFLOP, {f_b / 1e6:.1f} MB; "
          f"{n_fwd} CUDA launches), backward {k_b:.4f} ms (plain {p_b:.4f}, bound {bb:.4f} "
          f"{bbby}, f32 FMA bound {fma_b:.4f}; {b_ops / 1e9:.3f} GFLOP, {b_b / 1e6:.1f} MB; "
          f"{n_bwd} CUDA launches; the recomputed forward adds {recompute:.4f} ms at the "
          f"route's rate)", flush=True)
    return dict(dtype=str(dt)[6:], ms_fwd=k_f, ms_bwd=k_b, plain_ms_fwd=p_f, plain_ms_bwd=p_b,
                bound_ms_fwd=bf, bound_ms_bwd=bb, bound_by_fwd=bfby, bound_by_bwd=bbby,
                bound_by=bound(f_b + b_b, f_ops + b_ops, rate)[1], fma_bound_ms_fwd=fma_f,
                fma_bound_ms_bwd=fma_b, recompute_ms_bwd=recompute, cuda_launches_fwd=n_fwd,
                cuda_launches_bwd=n_bwd, gflop_fwd=f_ops / 1e9, gflop_bwd=b_ops / 1e9,
                mb_fwd=f_b / 1e6, mb_bwd=b_b / 1e6)


def qkv_attention_work(n, d, h, n_seq, tile=64, elem=4):
    """{part: (operations, bytes)} of qkv_attention_block at this shape on
    tensors of ``elem`` bytes an element (den f32): "proj" the qkv
    projection (h, W, b in, pqkv out), "attn_fwd" the attention forward
    (pqkv in, att and den out), "fwd" the two; "attn_bwd" the attention
    backward (pqkv, g, att, den in, dqkv out), "bwd" it and the dh / dW / db
    products (h, W in, dh, dW, db out).  The attention counted at the
    kernel's 64-row tile: a score product (q k^T, A v and their backward
    counterparts) counts only its causal half, tile (tile + 1) e
    operations, and a state product (q S, S += k^T v, ...) 2 tile e^2.
    Forward: 2 score and 2 state products a tile; backward: 2 + 2 in the
    prefix pass, 4 + 3 in the suffix pass."""
    e, s = d // h, n // n_seq
    tiles = n_seq * h * -(-s // tile)
    tri, state = tile * (tile + 1) * e, 2 * tile * e * e
    proj = (2 * n * d * 3 * d, elem * (n * d + 3 * d * d + 3 * d + 3 * n * d))
    attn_fwd = (tiles * (2 * tri + 2 * state), elem * (3 * n * d + n * d) + 4 * n * h)
    attn_bwd = (tiles * (6 * tri + 5 * state), elem * (3 * n * d + 2 * n * d + 3 * n * d)
                + 4 * n * h)
    grads = (4 * n * d * 3 * d + n * 3 * d, elem * (n * d + 3 * d * d + n * d + 3 * d * d + 3 * d))
    add = lambda *ws: (sum(w[0] for w in ws), sum(w[1] for w in ws))
    return {"proj": proj, "attn_fwd": attn_fwd, "fwd": add(proj, attn_fwd),
            "attn_bwd": attn_bwd, "bwd": add(attn_bwd, grads)}


def attn_tail_work(n, d, di, elem=4):
    """(forward, backward) operations and bytes of attn_tail_block on
    tensors of ``elem`` bytes an element: the backward takes two products
    per weight, 2x the forward's operations (what the gradients need;
    kernel D's recomputed forward, one forward more, is its design's extra
    cost and is printed beside the bound, as G's in ffn_work)."""
    w = elem * (d * d + 2 * d * di + 7 * d + di)
    f_ops = 2 * n * (d * d + 2 * d * di)
    return (f_ops, elem * 3 * n * d + w), (2 * f_ops, elem * 5 * n * d + 2 * w)


def causal_product_work(b, h, s, e, chunk=128, elem=4):
    """(forward, backward) (operations, bytes) of the causal product at this
    shape on tensors of ``elem`` bytes an element (den too), counted as
    kernel C's attention: per chunk of c rows (the JAX kernel's 128, the
    last one ragged: only the rows the data has) a score product counts its
    causal half, c (c + 1) e operations, and a state product (q S, S +=
    k^T v, ...) 2 c e^2; forward 2 + 2 of them, backward 6 + 5.  Bytes:
    each input read once, each output written once (forward phi(q), phi(k),
    v in, out and den out; backward those, out, den and dO in, three
    gradients out)."""
    tri = state = 0
    for t0 in range(0, s, chunk):
        c = min(chunk, s - t0)
        tri += c * (c + 1) * e
        state += 2 * c * e * e
    tri, state = b * h * tri, b * h * state
    n, rows = b * h * s * e, b * h * s
    return ((2 * tri + 2 * state, elem * (4 * n + rows)),
            (6 * tri + 5 * state, elem * (8 * n + rows)))


TAIL_GRADS = ("dh_in", "da_pre", "dWo", "dbo", "dln1_s", "dln1_b", "dW1", "db1", "dW2", "db2",
              "dln2_s", "dln2_b")
FFN_GRADS = ("dh", "dW1", "db1", "dW2", "db2", "dln2_s", "dln2_b")


def ffn_work(n, d, di, elem=4):
    """(forward, backward) (operations, bytes) of ffn_block on tensors of
    ``elem`` bytes an element: forward 4 N D DI (two products), backward
    8 N D DI (two products per weight: the gradients need no more; kernel
    G's recomputed forward, 4 N D DI more, is its design's extra cost,
    printed beside the bound); bytes each input read once, each output
    written once (forward h in, out out, the parameters; backward h and dO
    in, dh out, the parameters in and their gradients out)."""
    w = elem * (2 * d * di + di + 3 * d)
    f_ops = 4 * n * d * di
    return (f_ops, elem * 2 * n * d + w), (2 * f_ops, elem * 3 * n * d + 2 * w)


def latency_state_bytes(b, L, d, h, *, s_bytes):
    """Bytes of reading and writing the decode state (S and z of every
    layer, song and head) once."""
    e = d // h
    return 2 * s_bytes * L * b * h * (e * e + e)


def latency_work(b, T, L, d, di, h, *, w_bytes, s_bytes, nf=FIELDS, vf=256):
    """(operations, bytes) of a T-token latency-decode chunk of B songs, the
    function v8 and v7 both compute: 2 B (L (4 D^2 + 2 D DI) + D NF VF_PAD)
    operations a token; bytes the weights once a token (layer stack and
    padded heads in their stored type, the f32 head bias and final LN), the
    state read and written once a chunk, and each token's pe row and B x NF
    ids.  v7 streams the state every token: that is its design's cost, not
    the function's (``latency_state_bytes`` a token, printed beside)."""
    w = L * (4 * d * d + 2 * d * di) + d * nf * vf
    small = L * (9 * d + di)                     # the layers' biases and LN, stored type
    ops = T * 2 * b * w
    nbytes_ = (T * (w_bytes * (w + small) + 4 * (nf * vf + 2 * d + d + 2 * b * nf))
               + latency_state_bytes(b, L, d, h, s_bytes=s_bytes))
    return ops, nbytes_


def aug_state_bytes(b, L, d, h):
    """Bytes of reading and writing the f32 augmented state of v3, v1 and v2
    once: (E, E + 1) values a (layer, head, song)."""
    e = d // h
    return 2 * 4 * L * h * b * e * (e + 1)


def v5_state_bytes(b, L, d, h):
    """Bytes of reading and writing v5's f32 batch-major state once: S
    (E, H E) and z (H E) a (layer, song)."""
    e = d // h
    return 2 * 4 * L * b * (e * d + d)


def decode_token_work(b, L, d, di, *, w_bytes, state_bytes, nf=0, vf=256):
    """(operations, bytes) of one decode token of B songs through L layers,
    and through the padded heads when nf > 0: 2 B (L (4 D^2 + 2 D DI) +
    D NF VF_PAD) operations; bytes the weight matrices once in their stored
    type, the f32 biases and LN vectors, the state read and written once
    (``state_bytes``) and h in and out."""
    w = L * (4 * d * d + 2 * d * di) + d * nf * vf
    small = 4 * (L * (9 * d + di) + nf * vf)
    return 2 * b * w, w_bytes * w + small + state_bytes + 2 * 4 * b * d


def chunk_work(b, T, L, d, di, h, *, w_bytes, s_bytes, fold_rows, nf=FIELDS, vf=256):
    """(operations, bytes, state-streaming floor in bytes) of a T-token call
    of kernel B at B songs: T (2 B (L (4 D^2 + 2 D DI) + D NF VF_PAD) + 4 L B
    H E^2) operations (the state update and read too); bytes the layer
    weights and padded heads once in their stored type, the f32 fold
    (``fold_rows`` x D), head bias, in_linear bias and final LN, T pe rows,
    the state read and written once a call and the tokens.  The floor
    streams the layer weights and the state every token instead: the state
    does not fit the card's L2 and shared memory between tokens."""
    e = d // h
    w = L * (4 * d * d + 2 * d * di) + d * nf * vf
    layers = w_bytes * (w + L * (9 * d + di))
    state = latency_state_bytes(b, L, d, h, s_bytes=s_bytes)
    ops = T * (2 * b * w + 4 * L * b * h * e * e)
    nbytes_ = (layers + 4 * (nf * vf + fold_rows * d + 3 * d) + 4 * T * d + state
               + 4 * b * nf * (T + 1))
    return ops, nbytes_, T * (layers + state)


def window_work(b, h, s, d, w, mask, elem=4):
    """(forward, backward) (operations, bytes) of band attention at this
    shape on q, k, v, out and their gradients of ``elem`` bytes an element
    (the mask and the row LSE f32), the (query, key) pairs they count, and
    the pairs whose query and key are both kept.  The count takes every
    query with the keys of [q - w, q + w] within [0, S): the function's
    padded rows are outputs too.  Forward: 2 products (2 operations a pair
    and a column each); backward: 5 (S recomputed, dP, dV, dQ, dK).  Bytes:
    each input read once, each output written once."""
    q = torch.arange(s, dtype=torch.int64)
    lo, hi = torch.clamp(q - w, min=0), torch.clamp(q + w, max=s - 1)
    pairs = b * h * int((hi - lo + 1).sum())
    keep = (mask.detach().cpu() > 0).to(torch.int64)
    cs = torch.nn.functional.pad(keep.cumsum(1), (1, 0))
    kept_pairs = h * int(((cs[:, hi + 1] - cs[:, lo]) * keep).sum())
    n, rows = b * h * s * d, b * h * s
    f_bytes = elem * (3 * n + n) + 4 * (b * s + rows)
    b_bytes = elem * (5 * n + 3 * n) + 4 * (rows + b * s)
    return (4 * pairs * d, f_bytes), (10 * pairs * d, b_bytes), pairs, kept_pairs


def check_fused(tag, kernel, plain, inputs, g, names, tols=(1e-4, 1e-3)) -> float:
    """A fused kernel against its plain version at dropout 0 and 0.1
    (``kernel(p)``, ``plain(p)``: functions of ``inputs``): the output within
    ``tols[0]`` of its magnitude (1e-4), each gradient (``names``) within
    ``tols[1]`` of its own (1e-3).  Returns the largest output difference."""
    out_tol, grad_tol = tols
    d_err = 0.0
    for p_drop in (0.0, 0.1):
        ok, gk = fwd_bwd(kernel(p_drop), inputs, g)
        op_, gp = fwd_bwd(plain(p_drop), inputs, g)
        e = max_err(ok, op_)
        d_err = max(d_err, e)
        print(f"[{tag}] p={p_drop}: max|d out| {e:.3e} (max|out| {magnitude(op_):.3e})",
              flush=True)
        check(e <= out_tol * magnitude(op_), f"{tag} p={p_drop} forward: max|diff| {e}")
        worst = 0.0
        for name, x, y in zip(names, gk, gp):
            e = max_err(x, y) / magnitude(y)
            worst = max(worst, e)
            check(bool(torch.isfinite(x).all()), f"{tag} p={p_drop} {name}: not finite")
            check(e <= grad_tol, f"{tag} p={p_drop} {name}: max|diff| {e} of its magnitude")
        print(f"[{tag}] p={p_drop}: {len(names)} gradients, worst max|diff| / magnitude "
              f"{worst:.3e}", flush=True)
    return d_err


def check_tail(tag, tfb, d_in, g, seed_t, mid_drop, tols=(1e-4, 1e-3)) -> float:
    """Kernel D against its plain version (check_fused), the 12 gradients."""
    return check_fused(
        tag, lambda p: (lambda *a: tfb.attn_tail_block(*a, seed_t, p, mid_drop)),
        lambda p: (lambda *a: tfb.attn_tail_block_plain(*a, seed_t, p, mid_drop)), d_in, g,
        TAIL_GRADS, tols)


def parent_qkv_attention(h, wqkv, bqkv, n_seq, n_head, chunk):
    """Kernel C's earlier plain version, the control of phase 4's bf16
    gate: the projection in h's type, then the chunked attention with
    every product's output in that type (autograd for the backward)."""
    from reinforcement_learning_in_music_generation_torch.ops.linear_attention import (
        causal_linear_attention_bshe)
    n, d = h.shape
    q, k, v = (h @ wqkv + bqkv).split(d, dim=-1)
    shp = lambda x: x.reshape(n_seq, n // n_seq, n_head, d // n_head)
    return causal_linear_attention_bshe(shp(q), shp(k), shp(v), chunk=chunk).reshape(n, d)


def qkv_rounded_control(tab, h, wqkv, bqkv, g, n_seq, n_head):
    """Kernel C with its parent's bf16 fault put back: the attention passes
    read the stored residual pqkv (rounded to h's type, widened to f32) in
    place of the projection's f32 values; the backward as C's own.  ->
    (att, dh, dWqkv, dbqkv).  A control of the bf16 gate: no wrapper call,
    so the wrapper counts nothing."""
    eps = tab.DEFAULT_EPS
    with torch.no_grad():
        pqkv, _ = tab.project_kernel(h, wqkv, bqkv)
        att, den = tab.attention_kernel(pqkv.float(), n_seq, n_head, eps, h.dtype)
        dqkv = tab.backward_kernel(pqkv, g.to(h.dtype).contiguous(), att, den, n_seq, n_head,
                                   eps)
        return att, dqkv @ wqkv.T, h.T @ dqkv, dqkv.sum(0).to(wqkv.dtype)


def bf16_shares(x, y):
    """(max|x - y| / magnitude(y), mean|x - y| / mean|y|)."""
    d = (x.float() - y.float()).abs()
    return d.max().item() / magnitude(y), d.mean().item() / max(y.float().abs().mean().item(),
                                                                1e-30)


def qkv_bf16_readings(tab, h, wqkv, bqkv, g, n_seq, n_head, chunk):
    """Kernel C on bf16 tensors against its twin of JAX's arithmetic: for
    att, dh, dWqkv and dbqkv, {"kernel": shares, "control": shares,
    "finite": bool, "dtype": in h's type}, shares = bf16_shares against
    the twin; the control is qkv_rounded_control."""
    ok, gk = fwd_bwd(lambda h_, w_, b_: tab.qkv_attention_block(h_, w_, b_, n_seq, n_head,
                                                                chunk=chunk), (h, wqkv, bqkv), g)
    op, gp = fwd_bwd(lambda h_, w_, b_: tab.qkv_attention_block_plain(h_, w_, b_, n_seq, n_head,
                                                                      chunk=chunk),
                     (h, wqkv, bqkv), g)
    oc = qkv_rounded_control(tab, h, wqkv, bqkv, g, n_seq, n_head)
    return {name: {"kernel": bf16_shares(x, y), "control": bf16_shares(z, y),
                   "finite": bool(torch.isfinite(x.float()).all()), "dtype": x.dtype == h.dtype}
            for name, x, y, z in zip(C_BF16_GATES, (ok, *gk), (op, *gp), oc)}


def bf16_gate_failures(readings, gates, controls):
    """What ``gates`` ({tensor: (max share, mean share)}) refuses in a bf16
    readings dict ({tensor: {"kernel": shares, <control>: shares, "finite",
    "dtype"}}): the kernel above a limit, not finite or not in the inputs'
    type, or a control (``controls``: {key: what it is}; a tensor may lack
    one) not above the mean limit."""
    bad = []
    for name, r in readings.items():
        k_max, k_mean = r["kernel"]
        g_max, g_mean = gates[name]
        if not r["finite"] or not r["dtype"]:
            bad.append(f"{name}: not finite, or not in the inputs' type")
        if k_max > g_max or k_mean > g_mean:
            bad.append(f"{name}: max / mean share {k_max:.3e} / {k_mean:.3e} above "
                       f"{g_max:.3e} / {g_mean:.3e}")
        for key, what in controls.items():
            if key in r and not r[key][1] > g_mean:
                bad.append(f"{name}: {what}'s mean share {r[key][1]:.3e} is not above "
                           f"{g_mean:.3e}")
    return bad


def qkv_bf16_gate_failures(readings):
    """What C_BF16_GATES refuses in qkv_bf16_readings' result: the kernel
    above a limit, or the control not above the mean limit."""
    return bf16_gate_failures(readings, C_BF16_GATES, {"control": "the rounded-residual control"})


def product_bf16_readings(tlk, tla, pq, pk, v, g, eps, chunk):
    """Kernel F on bf16 tensors against its twin of JAX's bf16 arithmetic:
    for out, den, dq, dk and dv, {"kernel": shares, "control": shares,
    "control_f32_route": shares, "finite", "dtype": in the inputs' type},
    shares = bf16_shares against the twin.  The controls: the chunked
    composition in bf16 arithmetic (every product rounded), and, for the
    gradients, F's f32 route on the inputs widened to f32 (den unrounded,
    dnum and dd formed in f32), its outputs rounded to bf16 (on out and den
    it rounds the twin's f32 values: no control there).  Returns (readings,
    the kernel's five tensors)."""
    def run(fn):
        ts = [t.detach().clone().requires_grad_(True) for t in (pq, pk, v)]
        out, den = fn(*ts)
        return (out.detach(), den, *torch.autograd.grad(out, ts, g))

    ok = run(lambda *a: tlk.causal_product(*a, eps))
    op = run(lambda *a: tlk.causal_product_plain(*a, eps, chunk))
    t = lambda x: x.transpose(1, 2)
    oc = run(lambda a, b, c: tuple(x.transpose(1, 2) for x in tla._ChunkedCore.apply(
        t(a), t(b), t(c), eps, chunk)))
    with torch.no_grad():
        wide = [x.float() for x in (pq, pk, v)]
        o32, d32 = tlk.forward_kernel(*wide, eps)
        of = (o32, d32, *tlk.backward_kernel(*wide, o32, d32, g.float(), eps))
    readings = {}
    for name, x, y, z, f in zip(F_BF16_GATES, ok, op, oc, of):
        r = {"kernel": bf16_shares(x, y), "control": bf16_shares(z, y), "max_abs": max_err(x, y),
             "finite": bool(torch.isfinite(x.float()).all()), "dtype": x.dtype == pq.dtype}
        if name not in ("out", "den"):
            r["control_f32_route"] = bf16_shares(f.to(pq.dtype), y)
        readings[name] = r
    return readings, ok


def band_rounded_control(twk, q, k, v, mask, window, g):
    """Kernel E's twin with the flash-attention shortcut that JAX's kernel
    does not take: P rounded to q's type before P v and P^T dO, and dS
    before dS k and dS^T q; the rest as the twin (f32 from the widened
    inputs, dr = sum(dO out) from the rounded out, every output rounded on
    store) -> (out, dq, dk, dv).  Blocked over the queries as the twin.  A
    control of phase 7's bf16 gate; at float32 every rounding is the
    identity and it is the twin's function."""
    dt, dev = q.dtype, q.device
    rnd = lambda x: x.to(dt).float()
    b, h, s, d = q.shape
    w = max(1, window // 2)
    blk = min(twk.pick_blocks(s, window)[0], s)
    pad_s, scale = (-s) % blk, 1.0 / math.sqrt(d)
    kw = blk + 2 * w
    pad = torch.nn.functional.pad
    qp, gp = pad(q.float(), (0, 0, 0, pad_s)), pad(g.float(), (0, 0, 0, pad_s))
    kp, vp = pad(k.float(), (0, 0, w, w + pad_s)), pad(v.float(), (0, 0, w, w + pad_s))
    keep = torch.ones((b, s), device=dev) if mask is None else mask
    mp = pad(keep.float(), (w, w + pad_s)) > 0
    row = torch.arange(blk, device=dev)[:, None]
    col = torch.arange(kw, device=dev)[None, :]
    out, dq = torch.empty_like(qp), torch.empty_like(qp)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    for qs in range(0, s + pad_s, blk):
        key = qs - w + col
        band = ((col >= row) & (col <= row + 2 * w) & (key >= 0) & (key < s)) | (qs + row >= s)
        kept = mp[:, None, None, qs:qs + kw]
        qb, gb, kb, vb = qp[:, :, qs:qs + blk], gp[:, :, qs:qs + blk], kp[:, :, qs:qs + kw], \
            vp[:, :, qs:qs + kw]
        sc = torch.where(kept, torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale, twk.NEG_INF)
        p = torch.softmax(sc.masked_fill(~band, float("-inf")), dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", rnd(p), vb)
        out[:, :, qs:qs + blk] = o
        dr = (gb * rnd(o)).sum(-1, keepdim=True)
        dp = torch.einsum("bhqd,bhkd->bhqk", gb, vb)
        ds = rnd(torch.where(kept & band, p * (dp - dr), 0.0))
        dq[:, :, qs:qs + blk] = torch.einsum("bhqk,bhkd->bhqd", ds, kb) * scale
        dk[:, :, qs:qs + kw] += torch.einsum("bhqk,bhqd->bhkd", ds, qb) * scale
        dv[:, :, qs:qs + kw] += torch.einsum("bhqk,bhqd->bhkd", rnd(p), gb)
    return (out[:, :, :s].to(dt), dq[:, :, :s].to(dt), dk[:, :, w:w + s].to(dt),
            dv[:, :, w:w + s].to(dt))


def band_bf16_readings(twk, q, k, v, mask, window, g):
    """Kernel E on bf16 tensors against its twin of JAX's bf16 arithmetic:
    for out (the rows that see a kept key), dq, dk and dv, {"kernel":
    shares, "control": shares of band_rounded_control, "finite", "dtype"},
    shares = bf16_shares against the twin.  Returns (readings, the kernel's
    four tensors)."""
    def run(fn):
        ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*ts)
        return (out.detach(), *torch.autograd.grad(out, ts, g))

    ok = run(lambda *a: twk.window_attention_band(*a, mask, window))
    op = run(lambda *a: twk.window_attention_band_plain(*a, mask, window)[0])
    with torch.no_grad():
        oc = band_rounded_control(twk, q, k, v, mask, window, g)
    valid = (mask[:, None, :, None] > 0).to(q.dtype)
    readings = {}
    for name, x, y, z in zip(E_BF16_GATES, ok, op, oc):
        keep = valid if name == "out" else 1
        readings[name] = {"kernel": bf16_shares(x * keep, y * keep),
                          "control": bf16_shares(z * keep, y * keep),
                          "max_abs": max_err(x * keep, y * keep),
                          "finite": bool(torch.isfinite(x.float()).all()),
                          "dtype": x.dtype == q.dtype}
    return readings, ok


def bit_diffs(x, y) -> int:
    """Elements of x whose bits differ from y's (y rounded to x's type
    first; an element that is NaN on either side counts as differing)."""
    y = y.to(x.dtype)
    if x.shape != y.shape:
        return x.numel()
    it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    return int((x.contiguous().view(it) != y.contiguous().view(it)).sum())


def exact_gate_failures(readings: dict) -> list:
    """What the exact gate refuses in {tensor: {"kernel": differing
    elements against the reference, "control": the control's}}: any
    differing element of the kernel's, and a control with none (a gate
    that would pass the control is blind)."""
    bad = []
    for name, r in readings.items():
        if r["kernel"]:
            bad.append(f"{name}: {r['kernel']} elements differ from the f32 route, rounded")
        if not r["control"]:
            bad.append(f"{name}: the dropped-plane control equals the f32 route, rounded")
    return bad


def product_rounded_control(pq, pk, v, eps, chunk):
    """Kernel F's forward with a plane dropped from each f32 operand: the
    twin's chunked arithmetic (``ops/linear_attention.py _fwd_bshe``) on
    the inputs widened to f32, with the score tile A and the state (S, z)
    rounded to the inputs' type before their products -> (out, den)
    rounded to it.  At float32 every rounding is the identity and it is
    the twin's function.  The control of phase 11's exact gate."""
    dt = v.dtype
    rnd = lambda x: x.to(dt).float()
    q, k, vv = (x.transpose(1, 2).float() for x in (pq, pk, v))       # (B, S, H, E)
    b, s0, h, e = q.shape
    pad = (-s0) % chunk
    q, k, vv = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, vv))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=q.dtype, device=q.device))
    s_c = torch.zeros((b, h, e, vv.shape[-1]), dtype=q.dtype, device=q.device)
    z_c = torch.zeros((b, h, e), dtype=q.dtype, device=q.device)
    outs, dens = [], []
    for j0 in range(0, q.shape[1], chunk):
        qb, kb, vb = q[:, j0:j0 + chunk], k[:, j0:j0 + chunk], vv[:, j0:j0 + chunk]
        a = rnd(torch.einsum("bihe,bjhe->bhij", qb, kb) * mask)
        num = (torch.einsum("bhij,bjhf->bihf", a, vb)
               + torch.einsum("bihe,bhef->bihf", qb, rnd(s_c)))
        den = torch.einsum("bhij->bih", a) + torch.einsum("bihe,bhe->bih", qb, rnd(z_c))
        outs.append(num / (den + eps)[..., None])
        dens.append(den)
        s_c = s_c + torch.einsum("bjhe,bjhf->bhef", kb, vb)
        z_c = z_c + torch.einsum("bjhe->bhe", kb)
    out, den = torch.cat(outs, 1)[:, :s0], torch.cat(dens, 1)[:, :s0]
    return out.transpose(1, 2).to(dt), den.transpose(1, 2).to(dt)


def product_exact_readings(fwd, pq, pk, v, eps, got, chunk):
    """Phase 11's exact gate: kernel F's bf16 forward ``got`` = (out, den)
    against F's f32 route ``fwd`` (forward_kernel's signature) on the
    inputs widened, rounded to bf16, bit for bit; the control
    (product_rounded_control) must differ -> {tensor: {"kernel",
    "control"}} (differing elements)."""
    with torch.no_grad():
        o32, d32 = fwd(*(x.float() for x in (pq, pk, v)), eps)
        ref = (o32.to(pq.dtype), d32.to(pq.dtype))
        ctl = product_rounded_control(pq, pk, v, eps, chunk)
    return {name: {"kernel": bit_diffs(x, r), "control": bit_diffs(c, r)}
            for name, x, r, c in zip(("out", "den"), got, ref, ctl)}


def band_f32_route(fwd, bwd, q, k, v, mask32, window, g):
    """Kernel E's f32 route (forward_kernel / backward_kernel's signatures)
    on bf16 q, k, v and dO widened to f32, its out rounded to bf16 and that
    stored out, widened, handed to the backward as its out (bf16's D =
    rowsum(dO * O) reads the rounded out) -> (out, dq, dk, dv) rounded to
    the inputs' type."""
    with torch.no_grad():
        wide = [x.float() for x in (q, k, v)]
        o32, stats = fwd(*wide, mask32, window)
        out = o32.to(q.dtype)
        grads = bwd(*wide, mask32, out.float(), stats, g.float(), window)
    return (out, *(x.to(q.dtype) for x in grads))


def band_exact_readings(twk, fwd, bwd, q, k, v, mask32, window, g, got):
    """Phase 7's exact gate: kernel E's bf16 (out, dq, dk, dv) ``got``
    against band_f32_route, bit for bit; the control
    (band_rounded_control: P and dS rounded, a dropped plane of each) must
    differ -> {tensor: {"kernel", "control"}} (differing elements)."""
    ref = band_f32_route(fwd, bwd, q, k, v, mask32, window, g)
    with torch.no_grad():
        ctl = band_rounded_control(twk, q, k, v, mask32, window, g)
    return {name: {"kernel": bit_diffs(x, r), "control": bit_diffs(c, r)}
            for name, x, r, c in zip(("out", "dq", "dk", "dv"), got, ref, ctl)}


def as_bf16(tensors):
    return tuple(t.bfloat16() for t in tensors)


def step_errors(out_k, out_p, zero_grads=()) -> dict:
    """check_step's readings of a step (loss, per-field losses, params
    after Adam, grads, Adam updates) against a reference step: the loss's
    relative error, and the worst (error, leaf) of the gradients (over the
    leaf's magnitude), the parameters (over magnitude(p), and without the
    floor of 1) and the updates where the gradient's sign is settled."""
    lk, _, pk, gk, uk = out_k
    lp_, _, pp, gp, up = out_p
    rest = [k for k in gp if k not in zero_grads]
    g_worst = max((max_err(gk[k], gp[k]) / max(gp[k].abs().max().item(), 1e-30), k)
                  for k in rest)
    u_worst, u_seen = (0.0, ""), 0
    for k in rest:
        settled = gp[k].abs() > 1e-3 * gp[k].abs().max()
        u_seen += int(settled.sum().item())
        if settled.any():
            e = (uk[k] - up[k])[settled].abs().max().item() / up[k].abs().max().item()
            u_worst = max(u_worst, (e, k))
    p_worst = max((max_err(pk[k], pp[k]) / magnitude(pp[k]), k) for k in pp)
    p_leaf = max((max_err(pk[k], pp[k]) / max(pp[k].abs().max().item(), 1e-30), k)
                 for k in pp)
    return {"loss": abs(lk - lp_) / abs(lp_), "grads": g_worst, "params": p_worst,
            "params_leaf": p_leaf, "updates": u_worst, "updates_seen": u_seen}


# check_step's limits: (loss relative, gradients, parameters, updates)
STEP_GATES = {"loss": 1e-4, "grads": 1e-3, "params": 1e-4, "updates": 1e-3}


def step_gate_failures(errors: dict, gates: dict = STEP_GATES) -> list:
    """The readings of ``step_errors`` above ``gates``."""
    out = []
    for key, limit in gates.items():
        v = errors[key] if key == "loss" else errors[key][0]
        if not v <= limit:
            out.append(f"{key} {v:.3e} > {limit:g}" + ("" if key == "loss"
                                                         else f" ({errors[key][1]})"))
    return out


def check_step(tag, out_k, out_p, zero_grads=()) -> None:
    """One step on a kernel route against the same step on the plain route.
    ``zero_grads``: leaves whose gradient is 0 in exact arithmetic (the key
    bias of softmax attention adds q.b to every score of a row, which the
    softmax removes), so both routes hold rounding noise there: each must be
    below 1e-6 of the largest gradient of the step, and they are left out
    of the relative checks.
    Losses within 1e-4 relative; gradients within 1e-3 of their leaf's
    magnitude; parameters after Adam within 1e-4 of magnitude(p) = max(1,
    max|p|), the convention of every check here (per leaf without the
    floor, Adam's g / (|g| + eps) magnifies gradient rounding near g = 0 by
    up to 1/eps, which shows on the zero-initialised LayerNorm biases;
    printed too).  One step at lr 1e-4 moves a parameter by at most about
    1e-4, so the parameter check alone cannot see a wrong update: the
    updates are compared on their own scale, within 1e-3 of the leaf's
    largest, wherever |g_plain| exceeds the gradient check's limit (1e-3
    of the leaf's largest), so no sign is left to rounding; there
    g / (|g| + eps) moves by at most eps |dg| / g^2."""
    lk, lsk, pk, gk, uk = out_k
    lp_, lsp, pp, gp, up = out_p
    rel = abs(lk - lp_) / abs(lp_)
    print(f"[{tag}] loss kernel {lk:.7f} plain {lp_:.7f} (relative {rel:.2e}); "
          f"per field max relative {((lsk - lsp).abs() / lsp.abs()).max().item():.2e}",
          flush=True)
    check(rel <= 1e-4, f"{tag}: losses differ by {rel} relative")
    g_top = max(g.abs().max().item() for g in gp.values())
    for k in zero_grads:
        noise = max(gk[k].abs().max().item(), gp[k].abs().max().item())
        print(f"[{tag}] {k}: gradient 0 in exact arithmetic; largest |g| of the two routes "
              f"{noise:.3e} (largest gradient of the step {g_top:.3e})", flush=True)
        check(noise <= 1e-6 * g_top, f"{tag}: gradient {k} is {noise}, not rounding noise")
    e = step_errors(out_k, out_p, zero_grads)
    g_worst, p_worst, p_leaf, u_worst, u_seen = (e["grads"], e["params"], e["params_leaf"],
                                                 e["updates"], e["updates_seen"])
    print(f"[{tag}] gradients: worst max|diff| / leaf magnitude {g_worst[0]:.3e} "
          f"({g_worst[1]})", flush=True)
    print(f"[{tag}] params after one Adam step: worst max|diff| / magnitude "
          f"{p_worst[0]:.3e} ({p_worst[1]}); without the floor of 1: {p_leaf[0]:.3e} "
          f"({p_leaf[1]})", flush=True)
    n_prm = sum(t.numel() for t in up.values())
    print(f"[{tag}] Adam updates: worst max|diff| / leaf's largest update "
          f"{u_worst[0]:.3e} ({u_worst[1]}) over the {u_seen} of {n_prm} elements whose "
          f"gradient sign is settled", flush=True)
    check(g_worst[0] <= 1e-3, f"{tag}: gradient {g_worst[1]} differs by {g_worst[0]}")
    check(p_worst[0] <= 1e-4, f"{tag}: param {p_worst[1]} differs by {p_worst[0]}")
    check(u_worst[0] <= 1e-3, f"{tag}: update of {u_worst[1]} differs by {u_worst[0]}")


def latency_slice(cfg, params, dev, gen) -> list:
    """Phases 21-24: the latency kernels (v8 and v7 of csrc/latency_decode.cu)
    against their plain twin, ``cli generate`` on the latency path, the
    prompt prefill on the card, and the kernels' times.  Returns the two
    entries of the kernels line."""
    from reinforcement_learning_in_music_generation_torch import config as C
    from reinforcement_learning_in_music_generation_torch.apps import cli
    from reinforcement_learning_in_music_generation_torch.generate import sampler
    from reinforcement_learning_in_music_generation_torch.models import linear_transformer as lt
    from reinforcement_learning_in_music_generation_torch.ops import (
        decode_kernel_v4 as dk4, decode_kernel_v6 as dk6, sampling as smp)
    from reinforcement_learning_in_music_generation_torch.ops.experimental import (
        decode_kernel_v7 as dk7, decode_kernel_v8 as dk8)
    L, D, H, E, DI = cfg.n_layer, cfg.d_model, cfg.n_head, cfg.d_head, cfg.d_inner
    f32, bf16 = torch.float32, torch.bfloat16
    kern = {7: dk7.fused_decode_v7, 8: dk8.fused_decode_v8}
    rp = {f32: dk8.make_resident_params(params, cfg),
          bf16: dk8.make_resident_params(params, cfg, dtype=bf16)}
    cp = dict(temps=tuple(s.temperature for s in smp.CP_SAMPLING),
              topps=tuple(s.top_p if s.top_p is not None else float("inf")
                          for s in smp.CP_SAMPLING))
    modes = {True: dict(temps=(1.0,) * FIELDS, topps=(float("inf"),) * FIELDS), False: cp}

    def rand_tokens(steps, b):
        return torch.stack([torch.randint(0, v, (steps, b), generator=gen, device=dev)
                            for v in cfg.vocab_sizes], dim=-1).to(torch.int32)

    def kw(greedy):
        return dict(n_head=H, vocab_sizes=cfg.vocab_sizes, greedy=greedy, eps=cfg.attn_eps,
                    **modes[greedy])

    def plain(rp_, tok, st, t0, seed, n, greedy):
        k = kw(greedy)
        k.pop("vocab_sizes")
        return dk8.latency_decode_plain(rp_, tok, st.s, st.z, t0, seed, max_tokens=n, **k)[0]

    # -- 21. both kernels against the plain twin, teacher-forced, 32 tokens --
    errs, errs_bf16 = {}, {}
    for wdt, sdt in ((f32, f32), (bf16, f32), (bf16, bf16)):
        for b in (1, 5, 16):
            toks = rand_tokens(32, b)
            for greedy in (True, False):
                st = {v: dk4.init_state(cfg, b, sdt, dev) for v in (7, 8, 0)}
                agree, total = {7: 0, 8: 0}, 32 * b * FIELDS
                for t in range(32):
                    out = {v: kern[v](rp[wdt], toks[t], st[v].s, st[v].z, t, 5, max_tokens=1,
                                      **kw(greedy))[0] for v in (7, 8)}
                    op = plain(rp[wdt], toks[t], st[0], t, 5, 1, greedy)
                    check(torch.equal(out[7], out[8]), f"latency v7 != v8 at token {t}")
                    for v in (7, 8):
                        agree[v] += (out[v] == op).sum().item()
                torch.cuda.synchronize()
                check(torch.equal(st[7].s, st[8].s) and torch.equal(st[7].z, st[8].z),
                      "latency v7 and v8 states differ")
                ds = (st[8].s.float() - st[0].s.float()).abs().max().item()
                mag = st[0].s.float().abs().max().item()
                tag = (f"B={b} weights {str(wdt)[6:]} state {str(sdt)[6:]} "
                       f"{'greedy' if greedy else 'CP sampling'}")
                print(f"[latency] {tag}: teacher-forced agreement with the plain twin v8 "
                      f"{agree[8] / total:.4%}, v7 {agree[7] / total:.4%} (v7 == v8 bit for "
                      f"bit); max|ds| {ds:.3e} (max|s| {mag:.3e})", flush=True)
                for v in (7, 8):
                    check(agree[v] / total >= 0.99, f"latency v{v} {tag}: agreement "
                                                    f"{agree[v] / total} < 99%")
                if sdt == f32 and wdt == f32:
                    check(ds <= 1e-4 * max(1.0, mag), f"latency {tag}: max|ds| {ds}")
                    errs[b] = max(errs.get(b, 0.0), ds)
                elif sdt == f32:                # bf16 weights: kernel B's gate
                    check(ds <= S_TC_TOL * max(1.0, mag), f"latency {tag}: max|ds| {ds} > "
                                                           f"{S_TC_TOL} of max|s| {mag}")
                    errs_bf16[b] = max(errs_bf16.get(b, 0.0), ds / max(1.0, mag))
    tok0 = rand_tokens(1, 5)[0]
    for greedy in (True, False):            # whole fed-back calls: v7 == v8, bit for bit
        st = {v: dk4.init_state(cfg, 5, bf16, dev) for v in (7, 8)}
        out = {v: kern[v](rp[bf16], tok0, st[v].s, st[v].z, 0, 77, max_tokens=32,
                          **kw(greedy))[0] for v in (7, 8)}
        same = torch.equal(out[7], out[8]) and torch.equal(st[7].s, st[8].s) and \
            torch.equal(st[7].z, st[8].z)
        print(f"[latency] 32-token call, B=5, bf16, {'greedy' if greedy else 'CP sampling'}: "
              f"v7 and v8 {'identical' if same else 'DIFFERENT'}", flush=True)
        check(same, "latency: v7 and v8 calls differ")
    s1, s2 = dk4.init_state(cfg, 5, bf16, dev), dk4.init_state(cfg, 5, bf16, dev)
    one = dk8.fused_decode_v8(rp[bf16], tok0, s1.s, s1.z, 0, 99, max_tokens=64, **kw(False))[0]
    first = dk8.fused_decode_v8(rp[bf16], tok0, s2.s, s2.z, 0, 99, max_tokens=32, **kw(False))[0]
    second = dk8.fused_decode_v8(rp[bf16], first[-1].contiguous(), s2.s, s2.z, 32, 99,
                                 max_tokens=32, **kw(False))[0]
    same = torch.equal(one, torch.cat([first, second])) and torch.equal(s1.s, s2.s) and \
        torch.equal(s1.z, s2.z)
    print(f"[latency] v8 chunk invariance (64 vs 2x32 tokens, B=5): "
          f"{'identical' if same else 'DIFFERENT'}", flush=True)
    check(same, "latency v8: one call of 64 tokens differs from two of 32")
    big = dk8.MAX_BATCH + 1
    sb = dk4.init_state(cfg, big, bf16, dev)
    for v in (7, 8):
        try:
            kern[v](rp[bf16], rand_tokens(1, big)[0], sb.s, sb.z, 0, 0, max_tokens=1,
                    **kw(True))
            fail(f"latency v{v}: a batch of {big} was not refused")
        except ValueError as e:
            print(f"[latency] v{v} refuses B={big}: {e}", flush=True)

    # -- 22. cli generate on the latency path, beside the per-step path ------
    knobs = ("RLMG_LATENCY_DECODE", "RLMG_LATENCY_KERNEL")
    saved = {k: os.environ.pop(k, None) for k in knobs}
    # A's count is its runs as the kernel counts them (its wrapper sees only
    # the eager calls, not the token graph's replays)
    counters = {"A": dk4.fused_stack_step, "B": dk6.fused_decode_v6, "v7": dk7.fused_decode_v7,
                "v8": dk8.fused_decode_v8}
    launches, per_token, bar_token, rates = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for songs in (1, 5):
            for route, env in (("per-step", {}), ("v8", {"RLMG_LATENCY_DECODE": "1"}),
                               ("v7", {"RLMG_LATENCY_DECODE": "1", "RLMG_LATENCY_KERNEL": "v7"})):
                os.environ.update(env)
                for fn in counters.values():
                    fn.launches = 0
                for fn in (counters["v7"], counters["v8"]):
                    dk8.reset(fn)
                dk8.barriers_passed(reset=True)
                dk4.kernel_runs(reset=True)
                out = os.path.join(tmp, f"{route}-{songs}", "midis")
                res = cli.main(["generate", "--songs", str(songs), "--bars", "8",
                                "--max-tokens", "512", "--warmup", "--out-dir", out])
                torch.cuda.synchronize()
                counts = {k: fn.launches for k, fn in counters.items()}
                counts["A"] = dk4.kernel_runs()        # graph replays included
                n_bar = dk8.barriers_passed()
                for k in env:
                    os.environ.pop(k)
                rates[(route, songs)] = res["tokens_per_s"]
                print(f"[generate] {route} path, {songs} songs (8 bars, bf16): {res['tokens']} "
                      f"tokens in {res['seconds']:.3f}s = {res['tokens_per_s']:.1f} tokens/s; "
                      f"launches (with --warmup) {counts}", flush=True)
                mine = "A" if route == "per-step" else route
                check(counts[mine] > 0, f"generate {route} {songs} songs: its kernel never ran")
                check(all(n == 0 for k, n in counts.items() if k != mine),
                      f"generate {route} {songs} songs: another kernel ran: {counts}")
                for i in range(songs):
                    with open(os.path.join(out, f"get_{i}.mid"), "rb") as f:
                        check(f.read(4) == b"MThd", f"generate {route}: get_{i}.mid not a MIDI")
                with open(os.path.join(out, "..", "runtime_stats.json")) as f:
                    stats = json.load(f)
                check(len(stats["song_time"]) == songs and
                      sum(stats["words_len_list"]) == res["tokens"],
                      f"generate {route}: runtime_stats.json does not match the songs")
                if songs == 5:
                    launches[route] = counts[mine]
                if route == "per-step":
                    check(n_bar == 0, f"generate per-step: {n_bar} latency barriers counted")
                    continue
                # the kernels' own count of the grid barriers they passed, and
                # (v7) one token graph a shape serving every call of the run
                fn = counters[route]
                check(0 < n_bar <= (4 * L + 2) * fn.positions,
                      f"generate {route} {songs} songs: {n_bar} grid barriers for "
                      f"{fn.positions} token positions, above 4 L + 2 a position")
                if route == "v7":
                    check(fn.captures <= 1 < fn.launches,
                          f"generate v7 {songs} songs: {fn.captures} token graphs "
                          f"instantiated in {fn.launches} calls")
                print(f"[generate] {route}, {songs} songs: {fn.cuda_launches} CUDA launches "
                      f"and {n_bar} grid barriers (counted by the kernels) in {fn.launches} "
                      f"calls for {fn.positions} token positions = "
                      f"{fn.cuda_launches / fn.positions:.6g} launches and "
                      f"{n_bar / fn.positions:.6g} barriers a position; token graphs "
                      f"{fn.captures} instantiated, {fn.updates} updated", flush=True)
                if songs == 5:
                    per_token[route] = fn.cuda_launches / fn.positions
                    bar_token[route] = n_bar / fn.positions
            print(f"[generate] {songs} songs, tokens/s: per-step (kernel A) "
                  f"{rates[('per-step', songs)]:.1f}, v8 {rates[('v8', songs)]:.1f}, v7 "
                  f"{rates[('v7', songs)]:.1f}", flush=True)

    # -- 23. the prompt prefill on the card -----------------------------------
    prompt = rand_tokens(100, 1)[:, 0].cpu().numpy()
    for route, songs, env, fn in (("per-step", 5, {}, dk4.fused_stack_step),
                                  ("v6", 128, {}, dk6.fused_decode_v6),
                                  ("v8", 5, {"RLMG_LATENCY_DECODE": "1"}, dk8.fused_decode_v8)):
        os.environ.update(env)
        fn.launches = 0
        dk4.kernel_runs(reset=True)
        gcfg = C.GenerateConfig(batch_size=songs, max_tokens=64, bar_production=None,
                                token_count=64, seed=3)
        out = sampler.generate_songs(params, cfg, gcfg, init=prompt)
        torch.cuda.synchronize()
        # the per-step path's token graph replays A: its runs as A counts them
        n = dk4.kernel_runs() if fn is dk4.fused_stack_step else fn.launches
        for k in env:
            os.environ.pop(k)
        ok = all(s.shape == (164, FIELDS) and (s[:100] == prompt).all() for s in out)
        print(f"[prefill] 100-token prompt, {songs} songs on the {route} path: "
              f"{'ok' if ok else 'WRONG'} ({n} kernel launches)", flush=True)
        check(ok and len(out) == songs and n > 0, f"prefill on the {route} path")
    x = rand_tokens(100, 5).transpose(0, 1).contiguous()
    _, pst = lt.forward_prefill(params, cfg, x)
    scan = lt.init_decode_state(cfg, 5, device=dev)
    for t in range(100):
        _, scan = lt.decode_step(params, cfg, x[:, t], scan)
    torch.cuda.synchronize()
    ds = (pst.s - scan.s).abs().max().item()
    mag = scan.s.abs().max().item()
    print(f"[prefill] forward_prefill vs 100 decode steps, B=5, f32: max|ds| {ds:.3e} (max|s| "
          f"{mag:.3e}), max|dz| {(pst.z - scan.z).abs().max().item():.3e}", flush=True)
    check(ds <= 1e-3 * max(1.0, mag), f"prefill state differs from the scan's by {ds}")
    for k, v in saved.items():
        if v is not None:
            os.environ[k] = v

    # -- 24. times per token, bf16 weights and state ---------------------------
    # the bf16 products run on the tensor cores: HMMA in the SASS of the
    # bf16-weight instantiations of v8's kernel and v7's layer and heads
    # kernels (the f32-weight ones keep f32 FMAs)
    from reinforcement_learning_in_music_generation_torch.ops import _build
    cuobjdump = cuobjdump_path()
    check(cuobjdump is not None, "cuobjdump not found (toolkit or Triton's copy)")
    sass = subprocess.run([cuobjdump, "-sass", _build.build_all()["latency_decode"]],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump -sass failed: {sass.stderr[-500:]}")
    lat_mma = {k: n for k, n in mma_counts(sass.stdout, "latency_v").items()
               if "sample" not in k}
    print(f"[latency] HMMA instructions a kernel ({cuobjdump}): {lat_mma}", flush=True)
    bf16_kernels = {k: n for k, n in lat_mma.items() if "kernelI13__nv_bfloat16" in k}
    check(len(bf16_kernels) == 5 and all(n > 0 for n in bf16_kernels.values()),
          f"latency: no tensor-core instructions in the bf16-weight kernels {bf16_kernels}")
    design = dk8.barriers_per_token(L)        # the source's constant, printed beside
    T = 32
    dp16 = lt.make_decode_params(params, cfg, bf16)
    rows = {}
    for b in (1, 5, 16):
        tok = rand_tokens(1, b)[0]
        st = dk4.init_state(cfg, b, bf16, dev)
        row = {}
        for v in (8, 7, 8):                 # v8 twice: a first call warms the card
            row[v] = time_ms(lambda: kern[v](rp[bf16], tok, st.s, st.z, 0, 1, max_tokens=T,
                                             **kw(False)), 5) / T
        row["plain"] = time_ms(lambda: plain(rp[bf16], tok, st, 0, 1, 2, False), 2) / 2
        for v in (7, 8):
            dk8.reset(kern[v])
            dk8.barriers_passed(reset=True)
            kern[v](rp[bf16], tok, st.s, st.z, 0, 1, max_tokens=T, **kw(False))
            row[f"launches{v}"] = kern[v].cuda_launches / kern[v].positions
            row[f"barriers{v}"] = dk8.barriers_passed() / kern[v].positions
            check(row[f"barriers{v}"] <= 4 * L + 2, f"latency v{v} B={b}: "
                  f"{row[f'barriers{v}']} grid barriers a token > 4 L + 2")
        h = lt.embed_input(params, cfg, tok, 0, None).float()
        wa = dk4.workspace(dp16, b)
        row["A"] = time_ms(lambda: dk4.fused_stack_step(None, h, st.s, st.z, n_head=H,
                                                        work=wa), 20)
        ops, nb = latency_work(b, T, L, D, DI, H, w_bytes=2, s_bytes=2)
        bd, row["by"] = bound(nb, ops, BF16_FLOPS)
        row["bound"] = bd / T
        row["state"] = latency_state_bytes(b, L, D, H, s_bytes=2) / HBM_BYTES_PER_S * 1e3
        rows[b] = row
        print(f"[time] latency B={b} (bf16 weights and state), ms a token: v8 {row[8]:.4f}, v7 "
              f"{row[7]:.4f}, plain twin {row['plain']:.3f}, kernel A (layer stack only) "
              f"{row['A']:.4f}; bound {row['bound']:.4f} ({row['by']}); v7's state traffic "
              f"a token {row['state']:.4f}; grid barriers a token counted by the kernels "
              f"v8 {row['barriers8']:.4g}, v7 {row['barriers7']:.4g} (design {design}); CUDA "
              f"launches a token v8 {row['launches8']:.4g}, v7 {row['launches7']:.4g} (v8's "
              f"ring: {kern[8].slots} slots of 8 KB a block)", flush=True)
    pkg = "reinforcement_learning_in_music_generation_torch"
    tpu = "reinforcement_learning_in_music_generation_tpu/ops/experimental"
    entries = []
    for v, line in ((8, 315), (7, 200)):
        entry = {
            "name": f"latency_decode_v{v}", "route": "cuda",
            "source": f"{pkg}/csrc/latency_decode.cu",
            "replaces": f"{tpu}/decode_kernel_v{v}.py:{line}", "launches": launches[f"v{v}"],
            "launches_per_token": per_token[f"v{v}"], "max_abs_err": max(errs.values()),
            "max_ds_share_bf16_weights_f32_state": max(errs_bf16.values()),
            "barriers_per_token": bar_token[f"v{v}"], "hmma": sum(bf16_kernels.values()),
            "ms": rows[5][v], "plain_ms": rows[5]["plain"], "bound_ms": rows[5]["bound"],
            "bound_by": rows[5]["by"], "library_ms": None, "kernel_a_ms": rows[5]["A"],
            "unit": "ms per token of B=5 songs, bf16 weights and state, 32-token calls",
            "by_batch": {str(b): {"ms": r[v], "plain_ms": r["plain"], "kernel_a_ms": r["A"],
                                  "bound_ms": r["bound"], "bound_by": r["by"],
                                  "barriers_per_token": r[f"barriers{v}"]}
                         for b, r in rows.items()},
            "tokens_per_s_generate": {str(s): rates[(f"v{v}", s)] for s in (1, 5)},
            "tokens_per_s_generate_per_step": {str(s): rates[("per-step", s)] for s in (1, 5)}}
        if v == 7:
            entry["state_ms_per_token"] = rows[5]["state"]
        entries.append(entry)
    return entries


def aug_slice(cfg, params, dev, gen) -> list:
    """Phases 25-29: v3 (csrc/decode_aug.cu) against its plain twin and on
    its main path, odd-head ``generate_songs``; v1 and v2 (v3's source)
    through ``fused_decode_step``; v5 (csrc/latency_decode.cu) on its main
    path, ``scripts/profile_torch_decode_v5.py``'s parity and perf modes,
    and against its plain twin; then their times.  Returns the four entries
    of the kernels line."""
    import dataclasses
    import importlib.util

    from reinforcement_learning_in_music_generation_torch import config as C
    from reinforcement_learning_in_music_generation_torch.generate import sampler
    from reinforcement_learning_in_music_generation_torch.models import (
        common as cm, linear_transformer as lt)
    from reinforcement_learning_in_music_generation_torch.ops import (
        decode_kernel_v3 as dk3, decode_kernel_v4 as dk4, sampling as smp)
    from reinforcement_learning_in_music_generation_torch.ops.experimental import (
        decode_kernel as dk, decode_kernel_v5 as dk5, decode_kernel_v8 as dk8)
    L, D, H, DI = cfg.n_layer, cfg.d_model, cfg.n_head, cfg.d_inner
    f32, bf16 = torch.float32, torch.bfloat16
    cfg1 = dataclasses.replace(cfg, n_head=1)             # the odd head count dividing 512
    p16 = lt.cast_params(params, bf16)
    dparams = lt.make_decode_params(params, cfg)
    v3p = {(c.n_head, w): dk3.make_v3_params(params, c, dtype=w) for c in (cfg, cfg1)
           for w in (f32, bf16)}
    vocab = torch.tensor(cfg.vocab_sizes, device=dev)
    cp = dict(temps=tuple(s.temperature for s in smp.CP_SAMPLING),
              topps=tuple(s.top_p if s.top_p is not None else float("inf")
                          for s in smp.CP_SAMPLING))
    modes = {True: dict(temps=(1.0,) * FIELDS, topps=(float("inf"),) * FIELDS), False: cp}

    def rand_tokens(steps, b):
        return torch.stack([torch.randint(0, v, (steps, b), generator=gen, device=dev)
                            for v in cfg.vocab_sizes], dim=-1).to(torch.int32)

    def greedy_next(h):
        logits = lt.fused_logits(dparams, cfg, cm.layernorm(params["final_ln"], h))
        return torch.stack([lg.argmax(-1) for lg in logits], dim=-1)

    def layer(li, p=params):
        return {k: {kk: vv[li] for kk, vv in v.items()} for k, v in p["layers"].items()}

    # -- 25. v3 against its plain twin, 32 teacher-forced tokens -------------
    # v3's state is f32 whatever the weights, so every case is held to h and
    # state within 1e-4 of their magnitude.  A control, A's twin on the same
    # weights and tokens with every product's input rounded to bf16 (v6's
    # arithmetic), against the same twin unrounded, must end above that
    # gate: the gate tells f32-grade activations from rounded ones.
    dps = {w: lt.make_decode_params(params, cfg, w) for w in (f32, bf16)}
    v3_err, v3_share, v3_ctrl = 0.0, 0.0, float("inf")
    for c, b, wdt in ((cfg, 5, f32), (cfg, 32, f32), (cfg, 5, bf16), (cfg, 32, bf16),
                      (cfg, 128, bf16), (cfg1, 5, f32), (cfg1, 5, bf16), (cfg1, 32, bf16)):
        vp = v3p[(c.n_head, wdt)]
        w3 = dk3.workspace(vp, b)
        sk, sp = dk3.init_aug_state(c, b, dev), dk3.init_aug_state(c, b, dev)
        sa, sc = dk4.init_state(c, b, f32, dev), dk4.init_state(c, b, f32, dev)
        toks = rand_tokens(32, b)
        h_err, h_abs, c_err, agree = 0.0, 0.0, 0.0, 0
        for t in range(32):
            h0 = lt.embed_input(params, c, toks[t], t, None).float()
            hk, _ = dk3.fused_stack_step(None, h0, sk, n_head=c.n_head, eps=c.attn_eps, work=w3)
            hp, _ = dk3.fused_stack_step_plain(vp, h0, sp, n_head=c.n_head, eps=c.attn_eps)
            ha, _, _ = dk4.fused_stack_step_plain(dps[wdt], h0, sa.s, sa.z, n_head=c.n_head,
                                                  eps=c.attn_eps)
            hc, _, _ = dk4.fused_stack_step_plain(dps[wdt], h0, sc.s, sc.z, n_head=c.n_head,
                                                  eps=c.attn_eps, round_to=bf16)
            h_abs = max(h_abs, max_err(hk, hp))
            h_err = max(h_err, max_err(hk, hp) / magnitude(hp))
            c_err = max(c_err, max_err(hc, ha) / magnitude(ha))
            agree += (greedy_next(hk) == greedy_next(hp)).sum().item()
        torch.cuda.synchronize()
        s_err = max_err(sk, sp) / magnitude(sp)
        c_s = max_err(sc.s, sa.s) / magnitude(sa.s)
        frac = agree / (32 * b * FIELDS)
        tag = f"{c.n_head} head(s) of {D // c.n_head}, B={b}, weights {str(wdt)[6:]}"
        print(f"[v3] {tag}: max|dh| / magnitude {h_err:.3e} (max|dh| {h_abs:.3e}), max|ds| / "
              f"magnitude {s_err:.3e} (max|s| {sp.abs().max().item():.3e}); greedy agreement "
              f"{frac:.4%}; bf16-rounding control max|dh| / magnitude {c_err:.3e}, max|ds| / "
              f"magnitude {c_s:.3e}", flush=True)
        check(h_err <= 1e-4 and s_err <= 1e-4, f"v3 {tag}: h {h_err}, state {s_err}")
        check(c_err > 1e-4, f"v3 {tag}: the bf16-rounding control {c_err} is not above the "
                            "1e-4 gate")
        if wdt == bf16:
            check(frac >= 0.99, f"v3 {tag}: greedy agreement {frac} < 99%")
        v3_err = max(v3_err, h_abs)
        v3_share = max(v3_share, h_err, s_err)
        v3_ctrl = min(v3_ctrl, c_err)
        del w3

    # -- 26. the odd-head path end to end: generate_songs, default env --------
    knobs = [k for k in os.environ if k.startswith("RLMG_") and "DECODE" in k or k in (
        "RLMG_FUSED_SAMPLING", "RLMG_LATENCY_MAX_BATCH", "RLMG_PERSISTENT_MIN_BATCH")]
    saved = {k: os.environ.pop(k) for k in knobs}
    # a warm call with the timed call's settings (another seed) captures the
    # token graph, so the timed call replays it.  A's and v3's runs are
    # counted by the kernels, the graph's replays included: one a replay.
    rates, gen_launches = {}, {}
    for name, c in (("v3", cfg1), ("A", cfg)):
        gcfg = C.GenerateConfig(batch_size=5, max_tokens=512, bar_production=8, seed=11)
        sampler.generate_songs(p16, c, dataclasses.replace(gcfg, seed=12))
        torch.cuda.synchronize()
        for m in (dk3, dk4):
            m.fused_stack_step.launches = 0
            m.kernel_runs(reset=True)
        r0, c0 = sampler.generate_tokens.graph_replays, sampler.generate_tokens.graph_captures
        t = time.perf_counter()
        songs = sampler.generate_songs(p16, c, gcfg)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        mine = dk3 if name == "v3" else dk4
        counts = {"v3": dk3.kernel_runs(), "A": dk4.kernel_runs(),
                  "eager": mine.fused_stack_step.launches,
                  "replays": sampler.generate_tokens.graph_replays - r0,
                  "captures": sampler.generate_tokens.graph_captures - c0}
        n_tok = sum(len(s) for s in songs)
        ok = len(songs) == 5 and all(
            len(s) and ((s >= 0) & (s < vocab.cpu().numpy())).all() for s in songs)
        rates[name] = n_tok / sec
        gen_launches[name] = counts
        print(f"[generate_songs] {c.n_head} head(s), 5 songs, 8 bars, bf16 weights, warm: "
              f"{n_tok} tokens in {sec:.3f}s = {rates[name]:.1f} tokens/s; kernel runs (counted "
              f"by the kernels) and the token graph {counts}", flush=True)
        check(ok, f"generate_songs ({name}): a token outside its vocabulary")
        other = "A" if name == "v3" else "v3"
        check(counts[name] > 0 and counts[other] == 0,
              f"generate_songs ({name}): kernel runs {counts}")
        check(counts["captures"] == 0 and counts["replays"] > 0,
              f"generate_songs ({name}): the warm call did not serve the timed one {counts}")
        check(counts[name] == counts["replays"] + counts["eager"],
              f"generate_songs ({name}): {counts[name]} kernel runs for {counts['replays']} "
              f"graph replays and {counts['eager']} eager calls")
    os.environ.update(saved)
    g3 = gen_launches["v3"]
    v3_runs_per_token = g3["v3"] / (g3["replays"] + g3["eager"])
    print(f"[generate_songs] tokens/s: v3 at one head {rates['v3']:.1f}, kernel A at 8 heads "
          f"{rates['A']:.1f}; v3's runs a token {v3_runs_per_token:g}", flush=True)

    # -- 27. v1 and v2 through fused_decode_step, B=32, 16 tokens, f32 --------
    # v1 and v2 run A's token kernel a layer (the tanh gelu; v1 with its LN1
    # order, h + (att Wo + bo)): a variant's layers are packed by one launch
    # at their first call (the two variants share the packed layers, so the
    # cache is emptied before each), then one launch a call; the kernel
    # counts each variant's runs apart
    layer_err, layer_launch, layer_runs, layer_packs = {}, {}, {}, {}
    runs_of = {"v1": dk.kernel_runs_v1, "v2": dk.kernel_runs_v2}
    variants = (("v1", dk.fused_layer_step, dk.fused_layer_step_plain),
                ("v2", dk.fused_layer_step_v2, dk.fused_layer_step_v2_plain))
    for variant, fn, plain in variants:
        b = 32
        toks = rand_tokens(16, b)
        sk = lt.DecodeState(dk.aug_state_init(cfg, b, dev), None, 0)
        sp = dk.aug_state_init(cfg, b, dev)
        dk._V2_CACHE.clear()
        for counter in runs_of.values():
            counter(reset=True)
        fn.launches = fn.cuda_launches = fn.packs = 0
        h_err, h_abs = 0.0, 0.0
        for t in range(16):
            hk, sk = dk.fused_decode_step(params, cfg, toks[t], sk, variant=variant)
            hp = lt.embed_input(params, cfg, toks[t], t, None)
            for li in range(L):
                hp, _ = plain(hp, layer(li), sp[li], n_head=H, eps=cfg.attn_eps)
            hp = cm.layernorm(params["final_ln"], hp)
            h_abs = max(h_abs, max_err(hk, hp))
            h_err = max(h_err, max_err(hk, hp) / magnitude(hp))
        torch.cuda.synchronize()
        s_err = max_err(sk.s, sp) / magnitude(sp)
        runs = {v: counter() for v, counter in runs_of.items()}
        layer_err[variant] = h_abs
        layer_launch[variant] = (fn.launches, fn.cuda_launches)
        layer_runs[variant], layer_packs[variant] = runs[variant], fn.packs
        print(f"[{variant}] fused_decode_step B={b}, 16 tokens, f32: max|dh| / magnitude "
              f"{h_err:.3e}, max|ds| / magnitude {s_err:.3e}; wrapper calls {fn.launches}, "
              f"{fn.packs} packings (one a layer), {fn.cuda_launches} CUDA launches; "
              f"token-kernel runs as the kernel counts them {runs}", flush=True)
        check(h_err <= 1e-4 and s_err <= 1e-4, f"{variant}: h {h_err}, state {s_err}")
        check(fn.launches == 16 * L, f"{variant}: {fn.launches} calls, expected {16 * L}")
        other = "v2" if variant == "v1" else "v1"
        check(fn.packs == L and fn.cuda_launches == fn.launches + fn.packs
              and runs[variant] == fn.launches and runs[other] == 0,
              f"{variant}: {fn.cuda_launches} CUDA launches, {fn.packs} packings, runs {runs} "
              f"for {fn.launches} calls; expected one a call and one a layer's packing, the "
              "runs counted apart")
    # the layer gate (test_layer_kernels_match_plain's h gate, rtol = atol =
    # 1e-4) against the exact gelu: the same five tokens with each layer on
    # v3's token kernel (v2's layer with gelu_exact) must land above it
    layer_gate = {"v1": {}, "v2": {}}
    for wname, prm in (("float32", params),
                       ("bfloat16 layers", dict(params, layers={
                           k: {kk: vv.to(bf16) for kk, vv in v.items()}
                           for k, v in params["layers"].items()}))):
        v3l = dk3.make_v3_params(prm, cfg, dtype=prm["layers"]["wq"]["w"].dtype)
        toks = rand_tokens(5, 4)
        kw = dict(n_head=H, eps=cfg.attn_eps)

        def run(step):
            s = dk.aug_state_init(cfg, 4, dev)
            for t in range(5):
                h = lt.embed_input(prm, cfg, toks[t], t, None)
                for li in range(L):
                    h = step(h, layer(li, prm), s[li], li)
                h = cm.layernorm(prm["final_ln"], h)
            return h
        hc = run(lambda h, lp, s, li: dk3.fused_stack_step(
            {k: v[li:li + 1] for k, v in v3l.items()}, h.float().contiguous(), s[None],
            **kw)[0].clone())
        for variant, fn, plain in variants:
            dk._V2_CACHE.clear()
            c0, p0 = fn.cuda_launches, fn.packs
            hk = run(lambda h, lp, s, li: fn(h, lp, s, **kw)[0])
            launches = (fn.cuda_launches - c0, fn.packs - p0)
            hp = run(lambda h, lp, s, li: plain(h, lp, s, **kw)[0])
            torch.cuda.synchronize()
            k_ex, c_ex = gate_excess(hk, hp, 1e-4, 1e-4), gate_excess(hc, hp, 1e-4, 1e-4)
            layer_gate[variant][wname] = {"kernel": k_ex, "exact_gelu_control": c_ex}
            print(f"[{variant}] {wname} weights, B=4, 5 tokens: h against the twin at "
                  f"{k_ex:.3g} of the 1e-4 gate, the exact-gelu control at {c_ex:.3g}; CUDA "
                  f"launches and packings {launches} for {5 * L} calls", flush=True)
            fails = control_gate_failures(f"{variant} {wname}", k_ex, c_ex)
            check(not fails, "; ".join(fails))
            check(launches == (5 * L + L, L), f"{variant} {wname}: launches and packings "
                                               f"{launches}")

    # -- 28. v5: its main path, then against its plain twin -------------------
    spec = importlib.util.spec_from_file_location(
        "profile_torch_decode_v5", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                "scripts", "profile_torch_decode_v5.py"))
    prof5 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof5)
    dk5.fused_decode_v5.launches = dk5.fused_decode_v5.positions = 0
    par = {str(w)[6:]: prof5.parity(8, 64, dev, dtype=w) for w in (bf16, f32)}
    prf = prof5.perf(256, 128, dev, reps=1)
    torch.cuda.synchronize()
    v5_launches, v5_positions = dk5.fused_decode_v5.launches, dk5.fused_decode_v5.positions
    print(f"[v5] profile_torch_decode_v5 parity (bf16, f32) + perf: {v5_launches} kernel calls "
          f"for {v5_positions} token positions", flush=True)
    for w, r in par.items():
        print(f"[v5] free-running greedy parity with the per-step path, {w} weights: "
              f"{r['tokens'] - r['mismatches']}/{r['tokens']} tokens equal, first mismatch "
              f"(song, token, field) {r['first_mismatch']}", flush=True)
    check(v5_launches > 0, "v5: its main path never launched the kernel")
    # in f32 the streams differ only in the order of their sums; in bf16 the
    # reference also rounds its activations, so they part at near-ties early
    f32_par = par["float32"]
    check(f32_par["mismatches"] <= 0.01 * f32_par["tokens"],
          f"v5: f32 greedy parity {f32_par['mismatches']} of {f32_par['tokens']} tokens differ")
    check(all(r["stochastic_in_range"] for r in par.values())
          and all(r["in_range"] for r in prf["by_bb"].values()),
          "v5: a token outside its vocabulary")
    pe = cm.sinusoidal_table(cfg.max_len, D, f32, dev)
    b = 8
    toks = rand_tokens(64, b)
    v5_err = 0.0
    for wdt in (bf16, f32):
        v5p = dk5.make_v5_params(p16 if wdt == bf16 else params, cfg, dtype=wdt)
        for greedy in (True, False):
            kw = dict(n_head=H, max_tokens=1, greedy=greedy, eps=cfg.attn_eps, **modes[greedy])
            st = lt.init_decode_state(cfg, b, device=dev)
            s_own, z_own = dk5.pack_state(st.s, st.z)
            sp, zp = dk5.pack_state(st.s, st.z)
            agree = 0
            for t in range(64):
                s_tf, z_tf = sp.clone(), zp.clone()       # a call from the plain twin's state
                ok = dk5.fused_decode_v5(v5p, toks[t], s_tf, z_tf, pe[t:t + 1], 17 + t, bb=8,
                                         vocab_sizes=cfg.vocab_sizes, **kw)[0]
                dk5.fused_decode_v5(v5p, toks[t], s_own, z_own, pe[t:t + 1], 17 + t, bb=8,
                                    vocab_sizes=cfg.vocab_sizes, **kw)
                op = dk5.fused_decode_v5_plain(v5p, toks[t], sp, zp, pe[t:t + 1], 17 + t, **kw)[0]
                agree += (ok == op).sum().item()
                check(bool(((ok >= 0) & (ok < vocab)).all()), "v5: a token outside its vocabulary")
            torch.cuda.synchronize()
            frac = agree / (64 * b * FIELDS)
            ds = max(max_err(s_own, sp) / magnitude(sp), max_err(z_own, zp) / magnitude(zp))
            v5_err = max(v5_err, max_err(s_own, sp))
            mode = "greedy" if greedy else "CP sampling, one seed"
            print(f"[v5] B={b}, {str(wdt)[6:]} weights, f32 state, 64 tokens, {mode}: "
                  f"teacher-forced agreement with the plain twin {frac:.4%}; state after the "
                  f"same 64 fed tokens max|ds| / magnitude {ds:.3e}", flush=True)
            check(frac >= 0.99, f"v5 {str(wdt)[6:]} {mode}: agreement {frac} < 99%")
            check(ds <= 1e-3, f"v5 {str(wdt)[6:]} {mode}: state differs by {ds} of its magnitude")
    v5p = dk5.make_v5_params(p16, cfg)
    # every product of v5 (and of v1's and v2's token kernel) on the tensor
    # cores: HMMA in each instantiation's SASS.  v1 and v2 launch the same
    # two instantiations (the tanh gelu's, f32 and bf16 weights); v1 is a
    # field of the launch's arguments, not an instantiation of its own.
    v5_hmma, v2_hmma = {}, {}
    cuobj = cuobjdump_path()
    if cuobj is not None:
        from reinforcement_learning_in_music_generation_torch.ops import _build
        for lib, marker, out in (("latency_decode", "decode_v5_kernel", v5_hmma),
                                 ("decode_aug", "stack_tc_kernel", v2_hmma)):
            sass = subprocess.run([cuobj, "-sass", str(_build._target(lib))],
                                  capture_output=True, text=True).stdout
            out.update({k: n for k, n in mma_counts(sass, marker).items()
                        if lib == "latency_decode" or k.endswith("Lb1ELb1EEEvNS_11StackTcArgsE")})
        print(f"[v5] HMMA in decode_v5_kernel's instantiations {v5_hmma}; in v1's and v2's "
              f"token kernel (the tanh gelu's) {v2_hmma}", flush=True)
        check(len(v5_hmma) == 2 and min(v5_hmma.values()) > 0,
              f"v5: HMMA counts {v5_hmma}")
        check(len(v2_hmma) == 2 and min(v2_hmma.values()) > 0,
              f"v1 / v2: HMMA counts {v2_hmma}")
    else:
        print("[v5] no cuobjdump: the HMMA count is not read", flush=True)
    kw = dict(n_head=H, max_tokens=1, greedy=True, eps=cfg.attn_eps, **modes[True])
    st = lt.init_decode_state(cfg, b, device=dev)
    s_own, z_own = dk5.pack_state(st.s, st.z)
    try:
        dk5.fused_decode_v5(v5p, toks[0], s_own, z_own, pe, 0, bb=16,
                            vocab_sizes=cfg.vocab_sizes, **kw)
        fail("v5: bb=16 at B=8 was not refused")
    except ValueError as e:
        print(f"[v5] refuses bb=16 at B=8: {e}", flush=True)

    # -- 29. times: v3, v1, v2, v5 beside their plain twins, kernel A and v8 --
    dp16 = lt.make_decode_params(params, cfg, bf16)
    t3 = {}
    for c, b in ((cfg1, 5), (cfg1, 32), (cfg1, 128), (cfg, 5), (cfg, 32), (cfg, 128)):
        vp = v3p[(c.n_head, bf16)]
        st3 = dk3.init_aug_state(c, b, dev)
        h0 = lt.embed_input(params, c, rand_tokens(1, b)[0], 0, None).float()
        w3 = dk3.workspace(vp, b)
        n0 = dk3.fused_stack_step.cuda_launches
        dk3.kernel_runs(reset=True)
        ms = time_ms(lambda: dk3.fused_stack_step(None, h0, st3, n_head=c.n_head, work=w3), 20)
        per_call = (dk3.fused_stack_step.cuda_launches - n0) / 21
        check(dk3.kernel_runs() == 21, "v3: the kernel did not count one run a call")
        pms = time_ms(lambda: dk3.fused_stack_step_plain(vp, h0, st3, n_head=c.n_head), 3)
        row = {"ms": ms, "plain_ms": pms, "cuda_launches_per_token": per_call}
        if c.n_head % 2 == 0:
            sa = dk4.init_state(c, b, device=dev)
            wa = dk4.workspace(dp16, b)
            row["kernel_a_ms"] = time_ms(lambda: dk4.fused_stack_step(None, h0, sa.s, sa.z,
                                                                      n_head=c.n_head, work=wa),
                                         20)
        ops, nb = decode_token_work(b, L, D, DI, w_bytes=2,
                                    state_bytes=aug_state_bytes(b, L, D, c.n_head))
        row["bound_ms"], row["bound_by"] = bound(nb, ops, SPLIT3_BF16_FLOPS)
        t3[(c.n_head, b)] = row
        print(f"[time] v3 {c.n_head} head(s), B={b}, bf16 weights, f32 state: {ms:.4f} ms a "
              f"token ({per_call:g} CUDA launches), plain {pms:.3f}, kernel A "
              f"{row.get('kernel_a_ms', float('nan')):.4f} (bf16 state); bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
    b = 32
    h32 = lt.embed_input(params, cfg, rand_tokens(1, b)[0], 0, None).float()
    sa = dk4.init_state(cfg, b, f32, dev)
    wa = dk4.workspace(dparams, b)
    a32 = time_ms(lambda: dk4.fused_stack_step(None, h32, sa.s, sa.z, n_head=H, work=wa),
                  20) / L
    tl = {}
    for variant, fn, plain in variants:
        s1 = dk.aug_state_init(cfg, b, dev)[0]
        lp = layer(0)
        n0 = fn.cuda_launches
        ms = time_ms(lambda: fn(h32, lp, s1, n_head=H), 20)
        per_call = (fn.cuda_launches - n0) / 21
        dms = device_ms(lambda: fn(h32, lp, s1, n_head=H), 20)
        pms = time_ms(lambda: plain(h32, lp, s1, n_head=H), 5)
        ops, nb = decode_token_work(b, 1, D, DI, w_bytes=4,
                                    state_bytes=aug_state_bytes(b, 1, D, H))
        # the products at f32 grade on the tensor cores (six bf16 products a
        # product with f32 weights)
        bd, by = bound(nb, ops, SPLIT_BF16_FLOPS)
        tl[variant] = {"ms": ms, "device_ms": dms, "plain_ms": pms,
                       "kernel_a_ms_per_layer": a32, "cuda_launches_per_call": per_call,
                       "bound_ms": bd, "bound_by": by}
        print(f"[time] {variant} one layer, B={b}, f32 weights: {ms:.4f} ms a call "
              f"({per_call:g} CUDA launches a call, the packing included), on the device "
              f"{dms:.4f}, plain {pms:.3f}, kernel A's layer stack / L {a32:.4f} (f32 state); "
              f"bound {bd:.4f} ({by})", flush=True)
    t5 = {}
    rp16 = dk8.make_resident_params(params, cfg, dtype=bf16)
    for b, T, bbs in ((8, 64, (8,)), (256, 32, (8, 16, 32))):
        st = lt.init_decode_state(cfg, b, device=dev)
        s5, z5 = dk5.pack_state(st.s, st.z)
        tok = rand_tokens(1, b)[0]
        kw = dict(n_head=H, vocab_sizes=cfg.vocab_sizes, greedy=False, eps=cfg.attn_eps, **cp)
        for bb in bbs:
            dk5.fused_decode_v5.launches = dk5.fused_decode_v5.positions = 0
            ms = time_ms(lambda: dk5.fused_decode_v5(v5p, tok, s5, z5, pe[:T], 1, max_tokens=T,
                                                     bb=bb, **kw), 3) / T
            row = {"ms": ms, "bb": bb, "T": T, "launches_per_token":
                   dk5.fused_decode_v5.launches / max(1, dk5.fused_decode_v5.positions)}
            if bb == bbs[0]:
                kp = dict(kw)
                kp.pop("vocab_sizes")
                row["plain_ms"] = time_ms(lambda: dk5.fused_decode_v5_plain(
                    v5p, tok, s5, z5, pe[:1], 1, max_tokens=1, **kp), 1)
                sa = dk4.init_state(cfg, b, bf16, dev)
                h0 = lt.embed_input(params, cfg, tok, 0, None).float()
                wa = dk4.workspace(dp16, b)
                row["kernel_a_ms"] = time_ms(lambda: dk4.fused_stack_step(None, h0, sa.s, sa.z,
                                                                          n_head=H, work=wa), 10)
                if b <= dk8.MAX_BATCH:
                    s8 = dk4.init_state(cfg, b, bf16, dev)
                    row["v8_ms"] = time_ms(lambda: dk8.fused_decode_v8(
                        rp16, tok, s8.s, s8.z, 0, 1, max_tokens=T, **kw), 3) / T
                base = row
            ops, nb = decode_token_work(b, L, D, DI, w_bytes=2, nf=FIELDS,
                                        state_bytes=v5_state_bytes(b, L, D, H))
            row["bound_ms"], row["bound_by"] = bound(nb, ops, BF16_FLOPS)
            for k in ("plain_ms", "kernel_a_ms", "v8_ms"):
                if k in base:
                    row[k] = base[k]
            t5[(b, bb)] = row
            print(f"[time] v5 B={b} bb={bb}, bf16 weights, f32 state, {T}-token calls: "
                  f"{ms:.4f} ms a token, plain {row['plain_ms']:.3f}, kernel A (layer stack, "
                  f"bf16 state) {row['kernel_a_ms']:.4f}, v8 {row.get('v8_ms', float('nan')):.4f}"
                  f"; {row['launches_per_token']:g} launches a token; bound "
                  f"{row['bound_ms']:.4f} ({row['bound_by']})", flush=True)

    pkg = "reinforcement_learning_in_music_generation_torch"
    tpu = "reinforcement_learning_in_music_generation_tpu/ops"
    main3 = t3[(1, 5)]
    entries = [
        {"name": "decode_step_v3", "route": "cuda", "source": f"{pkg}/csrc/decode_aug.cu",
         "replaces": f"{tpu}/decode_kernel_v3.py:173", "launches": g3["v3"],
         "runs_per_token": v3_runs_per_token, "max_abs_err": v3_err,
         "max_share_of_magnitude": v3_share, "bf16_rounding_control_min_share": v3_ctrl,
         "ms": main3["ms"], "plain_ms": main3["plain_ms"], "bound_ms": main3["bound_ms"],
         "bound_by": main3["bound_by"], "library_ms": None,
         "unit": "ms per token of B=5 songs at one head of 512 (the odd-head path), bf16 "
                 "weights, f32 state",
         "by_batch": {f"{n} head(s), B={b}": t3[(n, b)] for n in (1, H) for b in (5, 32, 128)},
         "tokens_per_s_generate_songs": {"v3, one head": rates["v3"],
                                         f"kernel A, {H} heads": rates["A"]}},
    ]
    for variant, line in (("v1", 91), ("v2", 186)):
        r = tl[variant]
        entries.append({
            "name": f"decode_layer_{variant}", "route": "cuda",
            "source": f"{pkg}/csrc/decode_stack_tc.cuh",
            "entry_point": f"{pkg}/csrc/decode_aug.cu",
            "replaces": f"{tpu}/experimental/decode_kernel.py:{line}",
            "launches": layer_launch[variant][0],
            "cuda_launches_per_call": r["cuda_launches_per_call"],
            "packings": layer_packs[variant], "token_kernel_runs": layer_runs[variant],
            "max_abs_err": layer_err[variant], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "kernel_a_ms_per_layer": r["kernel_a_ms_per_layer"],
            "hmma": v2_hmma, "gelu_gate": layer_gate[variant],
            "unit": "ms per layer call of B=32 songs, f32 weights and state"})
    head5 = t5[(256, 8)]
    entries.append({
        "name": "decode_v5", "route": "cuda", "source": f"{pkg}/csrc/latency_decode.cu",
        "replaces": f"{tpu}/experimental/decode_kernel_v5.py:411", "launches": v5_launches,
        "launches_per_token": v5_launches / max(1, v5_positions), "max_abs_err": v5_err,
        "ms": head5["ms"], "plain_ms": head5["plain_ms"], "bound_ms": head5["bound_ms"],
        "bound_by": head5["bound_by"], "library_ms": None, "kernel_a_ms": head5["kernel_a_ms"],
        "hmma": v5_hmma,
        "unit": "ms per token of B=256 songs, bb 8, bf16 weights, f32 state, 32-token calls",
        "by_shape": {f"B={b} bb={bb}": r for (b, bb), r in t5.items()},
        "profile_parity": par, "profile_perf": prf})
    return entries


def slot_state_alone(dk4, lt, cm, params, cfg, dev, tokens, b=1, row=0):
    """(s, z) of one song's tokens (T, n_fields) teacher-forced from a zero
    state through kernel A at positions 0 .. T-1, in row ``row`` of a batch
    of b whose other rows take the song's first token each step (kernel A
    forms each row alone, but the batch can change its summation order)."""
    st = dk4.init_state(cfg, b, device=dev)
    dparams = lt.make_decode_params(params, cfg)
    work = dk4.workspace(dparams, b) if dev.type == "cuda" else None
    pe = cm.sinusoidal_table(cfg.max_len, cfg.d_model, params["in_linear"]["w"].dtype, dev)
    feed = tokens[:1].expand(b, -1).clone()
    for pos in range(tokens.shape[0]):
        feed[row] = tokens[pos]
        x = lt.embed_input(params, cfg, feed, pos, pe)
        dk4.fused_stack_step(dparams, x.float(), st.s, st.z, n_head=cfg.n_head,
                             eps=cfg.attn_eps, work=work)
    return st.s[:, row], st.z[:, row]


def refilled_slot_errors(dk4, lt, cm, params, cfg, dev, loop, toks, fin):
    """Each slot that was refilled, against its song decoded from a fresh
    state: the tokens since its last finish (after the init token)
    teacher-forced through kernel A from a zero state, in the slot's row of
    a batch of the loop's size, and alone at batch 1.  toks (T, B, nf) and
    fin (T, B) are every step the loop ran, so its state is the one after
    step T - 1.  Returns [(slot, share of magnitude at the loop's batch,
    bit-equal there, share of magnitude at batch 1)]."""
    out = []
    b = fin.shape[1]

    def share(s, z, k):
        return max(max_err(loop.s[:, k], s) / magnitude(s),
                   max_err(loop.z[:, k], z) / magnitude(z))
    for k in range(b):
        hits = torch.nonzero(fin[:, k]).flatten()
        if len(hits) == 0:
            continue
        last = int(hits[-1])
        seq = torch.cat([loop.tok0[k:k + 1], toks[last + 1:, k].to(dev)])
        s, z = slot_state_alone(dk4, lt, cm, params, cfg, dev, seq, b, k)
        s1, z1 = slot_state_alone(dk4, lt, cm, params, cfg, dev, seq)
        out.append((k, share(s, z, k),
                    bool(torch.equal(loop.s[:, k], s) and torch.equal(loop.z[:, k], z)),
                    share(s1, z1, k)))
    return out


def serving_slice(cfg, params, dev) -> dict:
    """Phases 31-33: the continuous batcher on kernel A against its eager
    loop and its slots against songs decoded alone; ``cli generate
    --continuous`` and ``--prompt``; the ``serve`` daemon and its restart.
    Returns the kernels' runs on these paths and the serving figures."""
    from reinforcement_learning_in_music_generation_torch import config as C
    from reinforcement_learning_in_music_generation_torch.apps import cli
    from reinforcement_learning_in_music_generation_torch.data import tokenizer
    from reinforcement_learning_in_music_generation_torch.generate import sampler, serving
    from reinforcement_learning_in_music_generation_torch.models import (
        common as cm, linear_transformer as lt)
    from reinforcement_learning_in_music_generation_torch.ops import (
        decode_kernel_v4 as dk4, decode_kernel_v6 as dk6, sampling as smp)
    f32, bf16 = torch.float32, torch.bfloat16
    gsc = serving.generate_songs_continuous
    n_songs, bars, batch, per_song = 24, 8, 8, 512
    kw = dict(n_songs=n_songs, bar_cond=bars, batch=batch, max_tokens_per_song=per_song)
    max_steps = -(-((-(-n_songs // batch) + 1) * per_song) // 1024) * 1024
    seed_row = torch.tensor(sampler.CP_SEED, dtype=torch.int32)
    record, serve_loop = {}, serving._serve_loop

    def recording(*a, **k):
        out = serve_loop(*a, **k)
        record.update(toks=torch.as_tensor(out[0]), fin=torch.as_tensor(out[1]))
        return out
    serving._serve_loop = recording

    def generator(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    # -- 31. the continuous batcher: graphed against eager, slots against alone
    figures, runs_serve = {}, 0
    try:
        for wname, wdt in (("float32", f32), ("bfloat16", bf16)):
            p_ = lt.cast_params(params, wdt)
            eager = gsc(p_, cfg, generator(31), graph=False, **kw)
            c0, r0 = gsc.graph_captures, gsc.graph_replays
            graphed = gsc(p_, cfg, generator(31), **kw)           # captures the step
            check(gsc.graph_captures == c0 + 1, f"serve loop ({wname}): no capture")
            check((graphed.steps, graphed.songs_done) == (eager.steps, eager.songs_done)
                  and len(graphed.songs) == len(eager.songs) == n_songs
                  and all(np.array_equal(a, b) for a, b in zip(graphed.songs, eager.songs)),
                  f"serve loop ({wname}): the graphed loop's songs differ from the eager loop's "
                  f"(steps {graphed.steps} / {eager.steps})")
            for song in graphed.songs:
                check(int((song[:, 2] == 1).sum()) == bars
                      and np.array_equal(song[0], seed_row.numpy()),
                      f"serve loop ({wname}): a song without {bars} bars or the CP seed")
            fin, toks = record["fin"], record["toks"]
            refilled = fin[:graphed.steps].any(0)
            check(bool(refilled.all()), f"serve loop ({wname}): slots never refilled: "
                                        f"{torch.nonzero(~refilled).flatten().tolist()}")
            c0 = gsc.graph_captures
            loop = serving._graphed_loop(p_, cfg, batch, max_steps, smp.CP_SAMPLING, 2, 1)
            check(gsc.graph_captures == c0, f"serve loop ({wname}): the loop is not cached")
            errs = refilled_slot_errors(dk4, lt, cm, p_, cfg, dev, loop, toks, fin)
            worst = max(e[1] for e in errs)
            print(f"[serve] {wname} weights: {len(errs)} refilled slots against their songs "
                  f"from a fresh state through kernel A at batch {batch}: largest share of "
                  f"magnitude {worst:.3e}, {sum(e[2] for e in errs)} of {len(errs)} "
                  f"bit-equal; at batch 1 (another summation order in kernel A): "
                  f"{max(e[3] for e in errs):.3e}", flush=True)
            check(len(errs) == batch and worst <= 1e-3,
                  f"serve loop ({wname}): a refilled slot's state is not a fresh one's "
                  f"({worst:.3e} of its magnitude)")
            # a warm request on a new seed, timed; kernel A's runs as it counts them
            torch.cuda.synchronize()
            dk4.kernel_runs(reset=True)
            eager0, r0, ran0 = dk4.fused_stack_step.launches, gsc.graph_replays, gsc.steps_run
            t = time.perf_counter()
            warm = gsc(p_, cfg, generator(32), **kw)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            runs = dk4.kernel_runs()
            replays, eager_n = gsc.graph_replays - r0, dk4.fused_stack_step.launches - eager0
            ran = gsc.steps_run - ran0
            check(runs == replays + eager_n and replays == ran > 0,
                  f"serve loop ({wname}): kernel A ran {runs} times for {replays} replays and "
                  f"{eager_n} eager calls")
            runs_serve += runs
            tokens = sum(len(x) for x in warm.songs)
            # synchronous batching of the same songs: waves of 8 in completion
            # order, each as long as its longest song; and generate_songs
            # itself in three batches of 8
            lens = [len(x) - 1 for x in warm.songs]
            sync_steps = sum(max(lens[i:i + batch]) for i in range(0, n_songs, batch))
            gcfg = C.GenerateConfig(n_songs=batch, bar_production=bars, max_tokens=per_song,
                                    batch_size=batch)
            sampler.generate_songs(p_, cfg, gcfg, generator=generator(33))      # warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            sync_songs = []
            for i in range(n_songs // batch):
                sync_songs += sampler.generate_songs(p_, cfg, gcfg, generator=generator(34 + i))
            torch.cuda.synchronize()
            sync_sec = time.perf_counter() - t
            sync_run_steps = sum(max(len(x) - 1 for x in sync_songs[i:i + batch])
                                 for i in range(0, n_songs, batch))
            sync_tokens = sum(len(x) for x in sync_songs)
            # the refill's share of a step: the refill alone captured on the
            # loop's buffers, against a replay of the whole step
            mask = torch.zeros(batch, dtype=torch.bool, device=dev)
            mask[::3] = True
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            refill_graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                loop.refill(mask)
                refill_graph.capture_begin()
                loop.refill(mask)
                refill_graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(stream)
            reps = 200
            loop.t.zero_()
            step_ms = time_ms(loop.graph.replay, reps, warmup=0)
            refill_ms = time_ms(refill_graph.replay, reps)
            del refill_graph
            figures[wname] = dict(
                tokens=tokens, seconds=sec, tokens_per_s=tokens / sec, steps=warm.steps,
                steps_run=ran, songs_done=warm.songs_done, sync_steps_same_songs=sync_steps,
                generate_songs_steps=sync_run_steps, generate_songs_tokens=sync_tokens,
                generate_songs_seconds=sync_sec, generate_songs_tokens_per_s=sync_tokens / sync_sec,
                step_ms=step_ms, refill_ms=refill_ms, refill_share=refill_ms / step_ms,
                kernel_a_runs=runs, replays=replays, eager_calls=eager_n,
                state_share=worst, bit_equal_slots=sum(e[2] for e in errs),
                state_share_batch1=max(e[3] for e in errs))
            f = figures[wname]
            print(f"[serve] {wname} weights, {n_songs} songs of {bars} bars on {batch} slots: "
                  f"{tokens} tokens in {sec:.3f}s = {f['tokens_per_s']:.1f} tokens/s; "
                  f"{warm.steps} decode steps ({ran} run, the host checking the stop every "
                  f"{sampler.STOP_CHECK_EVERY}) against {sync_steps} for synchronous batches of "
                  f"the same songs; generate_songs in 3 batches of {batch}: {sync_run_steps} "
                  f"steps, {f['generate_songs_tokens_per_s']:.1f} tokens/s; a replayed step "
                  f"{step_ms:.4f} ms, the refill alone {refill_ms:.4f} ms = "
                  f"{f['refill_share']:.1%} of it; kernel A ran {runs} times ({replays} replays, "
                  f"{eager_n} eager)", flush=True)
    finally:
        serving._serve_loop = serve_loop

    # -- 32. cli generate --continuous and --prompt ---------------------------
    written, write = [], tokenizer.write_midi_cp

    def recording_write(song, path, w2e):
        written.append(np.asarray(song).copy())
        return write(song, path, w2e)
    runs_prompt = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cont")
        dk4.kernel_runs(reset=True)
        res = cli.main(["generate", "--continuous", "--songs", str(n_songs),
                        "--continuous-batch", str(batch), "--bars", str(bars), "--max-tokens",
                        str(per_song), "--out-dir", out])
        a_runs = dk4.kernel_runs()
        for i in range(n_songs):
            with open(os.path.join(out, f"get_{i}.mid"), "rb") as fh:
                check(fh.read(4) == b"MThd", f"generate --continuous: get_{i}.mid is not a MIDI")
        check(res["songs"] == n_songs and a_runs > 0,
              f"generate --continuous: {res['songs']} songs, kernel A ran {a_runs} times")
        print(f"[generate --continuous] {n_songs} songs on {batch} slots: {res['tokens']} tokens "
              f"in {res['seconds']:.3f}s = {res['tokens_per_s']:.1f} tokens/s, {res['steps']} "
              f"steps; kernel A ran {a_runs} times", flush=True)
        runs_prompt["continuous_cli"] = a_runs
        prompt = os.path.join(tmp, "prompt.mid")
        longest = max(graphed.songs, key=len)
        tokenizer.write_midi_cp(longest, prompt, tokenizer.drop_type(
            tokenizer.construct_cp_dict())[1])
        rows = cli._prompt_rows(prompt)
        n_rows = min(len(rows), 48)
        p_bars = int((rows[:n_rows, 2] == 1).sum())
        check(n_rows >= 16, f"generate --prompt: the prompt has {n_rows} rows, fewer than the "
                            "prefill's 16")
        tokenizer.write_midi_cp = recording_write
        try:
            for songs, name in ((5, "A"), (128, "B")):
                written.clear()
                dk4.kernel_runs(reset=True)
                dk6.reset_counts()
                out = os.path.join(tmp, f"prompt{songs}")
                res = cli.main(["generate", "--songs", str(songs), "--bars", str(p_bars + 4),
                                "--max-tokens", "256", "--prompt", prompt, "--prompt-tokens",
                                str(n_rows), "--out-dir", out])
                n = dk4.kernel_runs() if name == "A" else dk6.fused_decode_v6.tc_calls
                runs_prompt[name] = n
                check(len(written) == songs == res["songs"] and n > 0,
                      f"generate --prompt, {songs} songs: kernel {name} ran {n} times")
                for song in written:
                    check(np.array_equal(song[:n_rows], rows[:n_rows])
                          and int((song[:, 2] == 1).sum()) == p_bars + 4,
                          f"generate --prompt, {songs} songs: a song without the prompt or "
                          f"{p_bars + 4} bars")
                print(f"[generate --prompt] {n_rows} prompt rows ({p_bars} bars), {songs} "
                      f"songs of {p_bars + 4} bars: {res['tokens']} tokens in "
                      f"{res['seconds']:.3f}s = {res['tokens_per_s']:.1f} tokens/s; kernel "
                      f"{name} ran {n} times", flush=True)
        finally:
            tokenizer.write_midi_cp = write

        # -- 33. cli serve, and a restart after its shutdown -----------------
        reqs = os.path.join(tmp, "requests.jsonl")
        served_dir = os.path.join(tmp, "served")
        lines = [{"id": "u", "songs": 3, "bars": 4, "seed": 1},
                 {"id": "p", "songs": 2, "bars": p_bars + 2, "prompt": prompt, "seed": 2},
                 {"songs": 2, "bars": 2}, {"cmd": "shutdown"}]
        with open(reqs, "w") as fh:
            fh.write("".join(json.dumps(x) + "\n" for x in lines))
        args = ["serve", "--requests", reqs, "--out-dir", served_dir, "--batch", str(batch),
                "--max-tokens", str(per_song), "--poll", "0.05"]
        dk4.kernel_runs(reset=True)
        res = cli.main(args)
        a_runs = dk4.kernel_runs()
        with open(os.path.join(served_dir, "responses.jsonl")) as fh:
            resp = [json.loads(x) for x in fh.read().splitlines() if x]
        check(res["served"] == 3 and [(r["id"], r["songs"]) for r in resp]
              == [("u", 3), ("p", 2), ("req", 2)] and a_runs > 0,
              f"serve: served {res['served']}, responses {resp}, kernel A ran {a_runs} times")
        for r in resp:
            for path in r["files"]:
                with open(path, "rb") as fh:
                    check(fh.read(4) == b"MThd", f"serve: {path} is not a MIDI")
        with open(reqs + ".journal") as fh:
            journal = fh.read().splitlines()
        check(journal[:2] == ["u", "p"] and len(journal) == 4
              and all(j.startswith("@") for j in journal[2:]), f"serve: journal {journal}")
        rate = res["served"] / res["seconds"]
        print(f"[serve] 3 requests (7 songs; one prompt request) in {res['seconds']:.3f}s = "
              f"{rate:.3f} requests/s; kernel A ran {a_runs} times; journal {journal}",
              flush=True)
        with open(reqs, "a") as fh:
            fh.write(json.dumps({"id": "late", "songs": 2, "bars": 3}) + "\n")
        res2 = cli.main(args + ["--idle-timeout", "1"])
        with open(os.path.join(served_dir, "responses.jsonl")) as fh:
            resp2 = [json.loads(x) for x in fh.read().splitlines() if x]
        with open(reqs + ".journal") as fh:
            journal2 = fh.read().splitlines()
        check(res2["served"] == 1 and [r["id"] for r in resp2] == ["u", "p", "req", "late"]
              and journal2 == journal + ["late"],
              f"serve restart: served {res2['served']}, responses {[r['id'] for r in resp2]}, "
              f"journal {journal2}")
        print(f"[serve] restarted after the shutdown: served only the appended request "
              f"({res2['served']}), journal {journal2}", flush=True)
    return dict(runs_serve=runs_serve, runs_prompt=runs_prompt, figures=figures,
                requests_per_s=rate, serve_a_runs=a_runs)


# the wrapper counters of the training kernels, in the order phase 5 reads
# them: (C fwd, C bwd, D fwd, D bwd, E fwd, E bwd, F fwd, F bwd, G fwd, G bwd)
def train_counters():
    from reinforcement_learning_in_music_generation_torch.ops import (
        attention_block as tab, ffn_block as tfb, linear_attention_kernel as tlk,
        window_attention_kernel as twk)
    return ((tab.qkv_attention_block, "launches_fwd"), (tab.qkv_attention_block, "launches_bwd"),
            (tfb.attn_tail_block, "launches_fwd"), (tfb.attn_tail_block, "launches_bwd"),
            (twk.window_attention_band, "launches_fwd"),
            (twk.window_attention_band, "launches_bwd"),
            (tlk.causal_product, "launches_fwd"), (tlk.causal_product, "launches_bwd"),
            (tfb.ffn_block, "launches_fwd"), (tfb.ffn_block, "launches_bwd"))


def dp_rank(spec: dict) -> dict:
    """Phases 34-35 on one rank of a group of ``spec["world"]`` ranks (2 by
    default): over gloo, every rank on card 0 (``dp_run`` spawns them;
    tests/test_torch_kernels_gpu.py at a small size); over nccl
    (``spec["backend"]``), rank r on card r (scripts/dp_nccl.py).
    ``spec``: the config's keywords ("cfg"), the global batch "B" x "S",
    "valid_tail" (the second half's rows keep only their first valid_tail
    positions, so the ranks' mask sums differ), "min_rows"
    (RLMG_FFN_MIN_ROWS; None keeps the default), phase 35's "songs",
    "max_tokens" and "bars" (no "songs": phase 34 alone), and "device"
    (gloo's card, default card 0; "cpu" rehearses the code on the kernels'
    plain versions, where the gates on the launches fail).

    Phase 34: one f32 step (dropout 0) on the rank's rows with dp_mesh, C
    and D counted; rank 0 also takes the same step in one process on the
    whole batch and holds the dp step against it (``step_errors``), and the
    control, the Adam step of the mean of the ranks' own means, against it
    too; the ranks' parameters after the step compared bit for bit; the
    all-reduce, the dp step and the one-process step timed; one bf16 step
    at dropout 0.1, and kernel D's output on equal inputs from equal
    generator states on both ranks (rank r's seed + 7919 r), beside the
    same call without the mesh.  Phase 35: ``generate_songs(mesh=...)``
    greedy with bf16 weights on kernel A (RLMG_FUSED_DECODE=1,
    RLMG_FUSED_SAMPLING=1), A's runs counted; rank 0 also decodes the same
    songs in one process; then a stochastic run."""
    import dataclasses
    import torch.distributed as dist
    from reinforcement_learning_in_music_generation_torch import config as C
    from reinforcement_learning_in_music_generation_torch.data import dataset
    from reinforcement_learning_in_music_generation_torch.generate import sampler
    from reinforcement_learning_in_music_generation_torch.models import linear_transformer as lt
    from reinforcement_learning_in_music_generation_torch.ops import (
        decode_kernel_v4 as dk4, ffn_block as tfb)
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    from reinforcement_learning_in_music_generation_torch.train import (
        optim as topt, pretrain as tpre)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k in ("RLMG_FFN_BACKEND", "RLMG_ATTN_BACKEND", "RLMG_WINDOW_BACKEND", "RLMG_FFN_MIN_ROWS",
              "RLMG_PERSISTENT_DECODE", "RLMG_LATENCY_DECODE"):
        os.environ.pop(k, None)
    if spec.get("min_rows"):
        os.environ["RLMG_FFN_MIN_ROWS"] = str(spec["min_rows"])
    world = spec.get("world", 2)
    if spec.get("backend", "gloo") == "nccl":      # launch put rank r on card r
        mesh = pm.make_mesh(world)
        dev, refused = mesh.device, None
    else:
        dev = torch.device(spec.get("device", "cuda:0"))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        try:                                        # NCCL takes a card a rank
            pm.make_mesh(world, devices=[dev] * world)
            refused = ""
        except ValueError as e:
            refused = str(e)
        mesh = pm.make_mesh(world, devices=[dev] * world, backend="gloo")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rank = mesh.rank
    out = {"rank": rank, "backend": mesh.backend, "nccl_refused": refused}
    # the path's collectives on CUDA tensors
    red = torch.full((4,), float(rank + 1), device=dev)
    pm.all_reduce_(mesh, [red], axis="world")
    bc = torch.full((4,), float(rank + 1), device=dev)
    pm.broadcast_(mesh, [bc], axis="world")
    ga = pm.all_gather(mesh, torch.full((2,), float(rank), device=dev), axis="world")
    out["collectives"] = {"all_reduce": red.tolist(), "broadcast": bc.tolist(),
                          "all_gather": torch.cat(ga).tolist(),
                          "all_gather_object": pm.all_gather_object(mesh, rank, axis="world")}

    # -- 34. the dp step ---------------------------------------------------
    counters = train_counters()

    def zero_counts():
        for fn, attr in counters:
            setattr(fn, attr, 0)

    def read_counts():
        return [getattr(fn, attr) for fn, attr in counters]

    cfg = C.LinearTransformerConfig(**spec["cfg"], dropout=0.0)
    p0 = lt.init_params(cfg, seed=0, device=dev)
    b, s_len, tail = spec["B"], spec["S"], spec["valid_tail"]
    x, y, m = dataset.synthetic_cp_dataset(b, s_len, n_class=cfg.vocab_sizes, seed=0)
    m = np.ones_like(m, dtype=np.float32)
    m[b // 2:, tail:] = 0.0
    full = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (x.astype(np.int64), y.astype(np.int64), m))
    mine = pm.shard_batch(mesh, full)
    out["rows"] = int(mine[0].shape[0]) * s_len
    out["mask_sum"] = float(mine[2].sum())
    tx = topt.adam(1e-4, grad_clip=3.0)

    def step(batch, dp_mesh):
        prm = topt.tree_map(torch.clone, p0)
        st = tx.init(prm)
        zero_counts()
        grads, (loss, losses) = tpre.agent_grad_step(prm, cfg, *batch, None, dp_mesh=dp_mesh)
        updates, _ = tx.update(grads, st, prm)
        prm, _ = tpre.apply_grads(prm, st, tx, grads)
        sync()
        return [float(loss), losses.cpu(), named_leaves(prm), named_leaves(grads),
                named_leaves(updates)], read_counts()

    dp_out, out["dp_counts"] = step(mine, mesh)
    flat = torch.cat([v.reshape(-1) for v in dp_out[2].values()])
    parts = pm.all_gather(mesh, flat, axis="world")
    out["ranks_equal"] = all(bool(torch.equal(parts[0], q)) for q in parts[1:])
    del flat, parts
    # the control: the mean of the ranks' own means, and its Adam step
    local, _ = step(mine, None)
    g_n = [g.clone() for g in local[3].values()]
    l_n = torch.tensor([local[0]], device=dev)
    ls_n = local[1].to(dev)
    pm.all_reduce_(mesh, g_n + [l_n, ls_n], axis="world")
    g_tree = topt.tree_unflatten(p0, [g / world for g in g_n])
    u_n, _ = tx.update(g_tree, tx.init(p0), p0)
    p_n = topt.tree_map(torch.add, p0, u_n)
    naive = [float(l_n) / world, (ls_n / world).cpu(), named_leaves(p_n), named_leaves(g_tree),
             named_leaves(u_n)]
    del local, g_n, g_tree, u_n, p_n
    dist.barrier()
    if rank == 0:
        ref, out["single_counts"] = step(full, None)
        out["loss"], out["loss_single"], out["loss_naive"] = dp_out[0], ref[0], naive[0]
        out["errors"] = step_errors(dp_out, ref)
        out["control"] = step_errors(naive, ref)
        del ref
    del dp_out, naive
    dist.barrier()

    def timed(batch, dp_mesh, n=3) -> float:
        prm = topt.tree_map(torch.clone, p0)
        st = tx.init(prm)
        prm, st, _ = tpre.agent_train_step(prm, st, cfg, tx, *batch, None, dp_mesh=dp_mesh)
        sync()
        t = time.perf_counter()
        for _ in range(n):
            prm, st, _ = tpre.agent_train_step(prm, st, cfg, tx, *batch, None, dp_mesh=dp_mesh)
        sync()
        return (time.perf_counter() - t) / n * 1e3

    leaves = [torch.zeros_like(t) for t in topt.tree_leaves(p0)]
    pm.all_reduce_(mesh, leaves, axis="world")
    sync()
    dist.barrier()
    t = time.perf_counter()
    for _ in range(3):
        pm.all_reduce_(mesh, leaves, axis="world")
    sync()
    out["allreduce_ms"] = (time.perf_counter() - t) / 3 * 1e3
    out["allreduce_bytes"] = sum(t.numel() * t.element_size() for t in leaves)
    del leaves
    dist.barrier()
    out["ms_dp"] = timed(mine, mesh)
    dist.barrier()
    if rank == 0:
        out["ms_single"] = timed(full, None)
    dist.barrier()

    # bf16 at dropout 0.1: a finite global loss, D counted; D's masks
    cfg_b = dataclasses.replace(cfg, dtype="bfloat16", dropout=0.1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    prm = topt.tree_map(torch.clone, p0)
    st = tx.init(prm)
    zero_counts()
    prm, st, (loss_b, _) = tpre.agent_train_step(prm, st, cfg_b, tx, *mine, gen, dp_mesh=mesh)
    sync()
    out["bf16"] = {"loss": float(loss_b), "counts": read_counts()}
    del prm, st
    lp0 = {k: {kk: vv[0].to(torch.bfloat16) for kk, vv in v.items()}
           for k, v in p0["layers"].items()}
    g_in = torch.Generator(device=dev)
    g_in.manual_seed(3)
    h_in = torch.randn((256, cfg.d_model), generator=g_in, device=dev).to(torch.bfloat16)
    a_in = torch.randn((256, cfg.d_model), generator=g_in, device=dev).to(torch.bfloat16)
    d_out = {}
    for name, dp_mesh in (("mesh", mesh), ("none", None)):
        g_s = torch.Generator(device=dev)
        g_s.manual_seed(77)
        seed = lt._dropout_seed(g_s, 0.1, dev, dp_mesh)
        o = tfb.attn_tail_block(h_in, a_in, lp0["wo"]["w"], lp0["wo"]["b"], lp0["ln1"]["scale"],
                                lp0["ln1"]["bias"], lp0["ffn1"]["w"], lp0["ffn1"]["b"],
                                lp0["ffn2"]["w"], lp0["ffn2"]["b"], lp0["ln2"]["scale"],
                                lp0["ln2"]["bias"], seed, 0.1)
        o_all = pm.all_gather(mesh, o.float(), axis="world")
        d_out[name] = (pm.all_gather_object(mesh, int(seed), axis="world"),
                       any(bool(torch.equal(o_all[i], o_all[j]))
                           for i in range(world) for j in range(i)))
    # "d_equal": some two ranks' outputs equal
    out["bf16"]["seeds"], out["bf16"]["d_equal"] = d_out["mesh"]
    out["bf16"]["seeds_none"], out["bf16"]["d_equal_none"] = d_out["none"]

    # -- 35. generate_songs on the mesh, kernel A on each rank ---------------
    if spec.get("songs"):
        os.environ["RLMG_FUSED_DECODE"] = "1"
        os.environ["RLMG_FUSED_SAMPLING"] = "1"
        pg = lt.cast_params(p0, torch.bfloat16)
        gcfg = C.GenerateConfig(batch_size=spec["songs"], max_tokens=spec["max_tokens"],
                                bar_production=spec["bars"], greedy=True)

        def a_runs(reset=False):              # A counts its runs, graph replays too
            return dk4.kernel_runs(reset) if dev.type == "cuda" else 0

        def decode(g_cfg, dp_mesh):
            sampler.generate_songs(pg, cfg, g_cfg, mesh=dp_mesh)    # builds the token graph
            sync()
            a_runs(reset=True)
            t = time.perf_counter()
            songs = sampler.generate_songs(pg, cfg, g_cfg, mesh=dp_mesh)
            sync()
            return songs, (time.perf_counter() - t) * 1e3, a_runs()

        dist.barrier()
        greedy, ms, runs = decode(gcfg, mesh)
        out["generate"] = {"greedy": greedy, "ms_dp": ms, "a_runs": runs}
        dist.barrier()
        if rank == 0:
            single, ms1, runs1 = decode(gcfg, None)
            out["generate"].update(single=single, ms_single=ms1, a_runs_single=runs1)
        dist.barrier()
        stoch = sampler.generate_songs(pg, cfg, dataclasses.replace(gcfg, greedy=False, seed=5),
                                       mesh=mesh)
        out["generate"]["stochastic"] = stoch
    return out


def dp_gate_failures(res: list, n_layer: int, vocab_sizes) -> list:
    """Phases 34-35's gates over every rank's ``dp_rank`` readings; the
    failures, each a line ([] when every gate holds)."""
    fails = []
    want = [n_layer] * 4 + [0] * 6
    world, r0 = len(res), res[0]
    for r in res:
        tag = f"rank {r['rank']}"
        if r["nccl_refused"] == "":
            fails.append(f"{tag}: make_mesh put NCCL ranks on one card")
        c = r["collectives"]
        if (c["all_reduce"] != [world * (world + 1) / 2] * 4 or c["broadcast"] != [1.0] * 4
                or c["all_gather"] != [float(i // 2) for i in range(2 * world)]
                or c["all_gather_object"] != list(range(world))):
            fails.append(f"{tag}: {r['backend']} collectives on CUDA tensors gave {c}")
        if r["dp_counts"] != want:
            fails.append(f"{tag}: dp step launches (C, D, E, F, G fwd/bwd) {r['dp_counts']}, "
                         f"expected {want}")
        if r["bf16"]["counts"] != want:
            fails.append(f"{tag}: bf16 dp step launches {r['bf16']['counts']}, expected {want}")
        if not math.isfinite(r["bf16"]["loss"]) or r["bf16"]["loss"] != r0["bf16"]["loss"]:
            fails.append(f"{tag}: bf16 dp step loss {r['bf16']['loss']} (rank 0: "
                         f"{r0['bf16']['loss']})")
        if not r["ranks_equal"]:
            fails.append(f"{tag}: the ranks' parameters differ after the dp step")
        if "generate" in r and not r["generate"]["a_runs"] > 0:
            fails.append(f"{tag}: kernel A ran no time on the mesh")
    if len({r["mask_sum"] for r in res}) == 1:
        fails.append("the ranks' mask sums are equal: the control cannot fail")
    if r0["single_counts"] != want:
        fails.append(f"one-process step launches {r0['single_counts']}, expected {want}")
    bad = step_gate_failures(r0["errors"])
    if bad:
        fails.append(f"dp step against the one-process step: {bad}")
    if not step_gate_failures(r0["control"]):
        fails.append("the control (mean of the ranks' means) passes the step gate")
    seeds = r0["bf16"]["seeds"]
    if [q - seeds[0] for q in seeds] != [7919 * i for i in range(world)] or r0["bf16"]["d_equal"]:
        fails.append(f"kernel D's seeds on the ranks {seeds}: the masks do not differ")
    if len(set(r0["bf16"]["seeds_none"])) != 1:
        fails.append(f"without the mesh the ranks drew the seeds {r0['bf16']['seeds_none']}")
    if "generate" in r0:
        g0 = r0["generate"]
        if len(g0["greedy"]) != len(g0["single"]) or any(
                not np.array_equal(a, b) for a, b in zip(g0["greedy"], g0["single"])):
            fails.append("greedy songs on the mesh differ from one process's")
        for r in res[1:]:
            for key in ("greedy", "stochastic"):
                if any(not np.array_equal(a, b) for a, b in zip(g0[key], r["generate"][key])):
                    fails.append(f"{key}: rank {r['rank']} returned another list than rank 0")
        st = g0["stochastic"]
        per = len(st) // world
        seed_row = np.asarray((0, 0, 1, 0, 0, 0))
        for i, song in enumerate(st):
            if (len(song) < 2 or not np.array_equal(song[0], seed_row)
                    or (song < 0).any() or (song >= np.asarray(vocab_sizes)).any()):
                fails.append(f"stochastic song {i} is not a valid song")
        if any(np.array_equal(st[i], st[j]) for i in range(len(st)) for j in range(i)
               if i // per != j // per):
            fails.append("a rank's stochastic song is a copy of another rank's")
    return fails


def dp_run(cfg, smi_line, world: int = 2, backend: str = "gloo", batch: int = 32) -> None:
    """``world`` ranks of ``dp_rank`` at ``cfg``'s width, ``batch`` x 512
    global, with phase 35's 8 songs: over gloo all on card 0 (phases 34-35),
    over nccl a card each (scripts/dp_nccl.py); prints the readings and fails
    on ``dp_gate_failures``."""
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    spec = {"cfg": dict(vocab_sizes=cfg.vocab_sizes), "B": batch, "S": 512, "valid_tail": 100,
            "min_rows": None, "songs": 8, "max_tokens": 256, "bars": 8, "world": world,
            "backend": backend}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()        # the ranks are processes of their own
    t = time.perf_counter()
    res = pm.launch(dp_rank, world, (spec,), backend=backend, timeout_s=600)
    wall = time.perf_counter() - t
    r0 = res[0]

    def each(key, fmt):
        return " / ".join(format(r[key], fmt) for r in res)
    cards = "all on card 0" if backend == "gloo" else "a card each"
    e, c = r0["errors"], r0["control"]
    print(f"[dp] {world} ranks over {backend}, {cards} ({smi_line}); make_mesh's refusal of "
          f"NCCL ranks sharing a card: {(r0['nccl_refused'] or '')[:80]!r}; the collectives on "
          f"CUDA tensors: {r0['collectives']}; {wall:.1f}s with the ranks' start", flush=True)
    print(f"[dp] 34: rows a rank {r0['rows']}, mask sums {each('mask_sum', '.0f')}; launches "
          f"(C, D, E, F, G fwd/bwd) a rank {[r['dp_counts'] for r in res]}, one process "
          f"{r0['single_counts']}", flush=True)
    print(f"[dp] 34: loss dp {r0['loss']:.7f}, one process {r0['loss_single']:.7f}, mean of the "
          f"ranks' means {r0['loss_naive']:.7f}; dp against one process: loss {e['loss']:.2e}, "
          f"gradients {e['grads'][0]:.3e} ({e['grads'][1]}), params {e['params'][0]:.3e}, "
          f"updates {e['updates'][0]:.3e}; the control: loss {c['loss']:.2e}, gradients "
          f"{c['grads'][0]:.3e} ({c['grads'][1]}), params {c['params'][0]:.3e}, updates "
          f"{c['updates'][0]:.3e} (gates {STEP_GATES}); ranks' params after the step "
          f"{'bit-equal' if all(r['ranks_equal'] for r in res) else 'DIFFERENT'}", flush=True)
    share = "; ranks sharing one card share its SMs, so these times say nothing of scaling" \
        if backend == "gloo" else ""
    print(f"[dp] 34: ms a step (f32, C + D): {each('ms_dp', '.1f')} on the ranks at once "
          f"({r0['rows'] // 512} x 512 rows each), {r0['ms_single']:.1f} in one process "
          f"({batch} x 512); the gradients' all-reduce ({r0['allreduce_bytes'] / 2**20:.1f} MiB) "
          f"{each('allreduce_ms', '.1f')} ms{share} ({smi_line})", flush=True)
    b0 = r0["bf16"]
    print(f"[dp] 34: bf16 at dropout 0.1: loss {b0['loss']:.6f} on every rank, launches "
          f"{b0['counts']}; kernel D's seeds from one generator state {b0['seeds']} (outputs "
          f"on equal inputs {'some equal' if b0['d_equal'] else 'all different'}), without "
          f"the mesh {b0['seeds_none']} ({'equal' if b0['d_equal_none'] else 'different'})",
          flush=True)
    g = [r["generate"] for r in res]
    print(f"[dp] 35: generate_songs on the mesh, {len(g[0]['greedy'])} songs greedy, bf16 "
          f"weights: {sum(len(x) for x in g[0]['greedy'])} tokens, kernel A's runs "
          f"{[x['a_runs'] for x in g]} on the ranks ({g[0]['a_runs_single']} in one process); "
          f"{' / '.join(format(x['ms_dp'], '.1f') for x in g)} ms on the ranks, "
          f"{g[0]['ms_single']:.1f} ms in one process ({smi_line}); greedy songs equal one "
          f"process's: {all(np.array_equal(a, b) for a, b in zip(g[0]['greedy'], g[0]['single']))}"
          f"; stochastic: {[len(x) for x in g[0]['stochastic']]} tokens", flush=True)
    fails = dp_gate_failures(res, cfg.n_layer, cfg.vocab_sizes)
    check(not fails, f"dp over {backend}: " + "; ".join(fails))


# tensor parallelism's phases 36-38: the tp step's gates (f32 as check_step;
# bf16 loss and gradients within BF16_STEP_GATES: bf16 keeps 8 bits, unit
# roundoff 2^-9 ~ 2e-3, and the tp and one-process steps round the
# row-parallel sums at other points through 12 layers; Adam's first step
# moves every parameter by about lr whatever the gradient's size, so the
# parameters and updates say nothing more at bf16)
BF16_STEP_GATES = {"loss": 1e-2, "grads": 5e-2}


class _CollectiveCount:
    """Counts torch.distributed's all_reduce and all_gather calls (and their
    elements) while it is entered."""

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.calls = dist, {}

    def __enter__(self):
        self.saved = {n: getattr(self.dist, n) for n in ("all_reduce", "all_gather")}
        for name, fn in self.saved.items():
            def counted(*a, _fn=fn, _name=name, **k):
                t = a[0] if _name == "all_reduce" else a[1]
                c = self.calls.setdefault(_name, [0, 0])
                c[0] += 1
                c[1] += t.numel()
                return _fn(*a, **k)
            setattr(self.dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def tp_rank(spec: dict) -> dict:
    """Phases 36-38 on one rank of a (dp, tp) mesh of ``spec["dp"]`` x
    ``spec["tp"]`` ranks: over gloo every rank on card 0 (``tp_run`` spawns
    them; tests/test_torch_kernels_gpu.py at a small size), over nccl
    (``spec["backend"]``) rank r on card r (scripts/dp_nccl.py --tp).
    ``spec``: the config's keywords ("cfg"), the global batch "B" x "S",
    "valid_tail" (the second half's rows keep only their first valid_tail
    positions, so the dp indices' mask sums differ), "routes" (of "plain",
    "f": RLMG_ATTN_BACKEND=pallas), "bf16" (one bf16 step on the F route),
    "control" (the step with torch.distributed.nn's all_reduce in place of
    reduce_from_tp), "songs" / "max_tokens" (phase 38's greedy songs, f32
    weights, then 32 stochastic tokens a song; none: no generation),
    "device" (gloo's card; "cpu" rehearses on the kernels' plain
    versions).

    Each step: one f32 step (dropout 0) on the rank's rows and tp shards,
    the kernels' wrapper counts and the collectives counted, the gathered
    parameters, gradients and updates; rank 0 also takes the same step in
    one process on the whole batch on the same route and holds the tp step
    against it (``step_errors``).  Then the times on the F route at f32:
    the tp step, one process's step and the dp step at the same global
    batch (a mesh of dp = dp x tp over the same ranks), and an all-reduce of
    one activation over the tp group."""
    import dataclasses
    import torch.distributed as dist
    import torch.distributed.nn.functional as dnf
    from reinforcement_learning_in_music_generation_torch import config as C
    from reinforcement_learning_in_music_generation_torch.data import dataset
    from reinforcement_learning_in_music_generation_torch.generate import sampler
    from reinforcement_learning_in_music_generation_torch.models import linear_transformer as lt
    from reinforcement_learning_in_music_generation_torch.ops import (
        decode_kernel_v4 as dk4, linear_attention_kernel as tlk)
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    from reinforcement_learning_in_music_generation_torch.parallel import sharding as psh
    from reinforcement_learning_in_music_generation_torch.parallel import tensor as ptn
    from reinforcement_learning_in_music_generation_torch.train import (
        optim as topt, pretrain as tpre)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k in ("RLMG_FFN_BACKEND", "RLMG_ATTN_BACKEND", "RLMG_WINDOW_BACKEND", "RLMG_FFN_MIN_ROWS",
              "RLMG_PERSISTENT_DECODE", "RLMG_LATENCY_DECODE", "RLMG_FUSED_DECODE"):
        os.environ.pop(k, None)
    dp, tp = spec["dp"], spec["tp"]
    world = dp * tp
    if spec.get("backend", "gloo") == "nccl":
        mesh = pm.make_mesh(dp, tp)
        dev = mesh.device
        dp_mesh = pm.make_mesh(world, 1)
    else:
        dev = torch.device(spec.get("device", "cuda:0"))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = pm.make_mesh(dp, tp, devices=[dev] * world, backend="gloo")
        dp_mesh = pm.make_mesh(world, 1, devices=[dev] * world, backend="gloo")
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rank = mesh.rank
    out = {"rank": rank, "dp_index": mesh.dp_index, "tp_index": mesh.tp_index,
           "backend": mesh.backend}
    counters = train_counters()

    def zero_counts():
        for fn, attr in counters:
            setattr(fn, attr, 0)

    def read_counts():
        return [getattr(fn, attr) for fn, attr in counters]

    cfg = C.LinearTransformerConfig(**spec["cfg"], dropout=0.0)
    p0 = lt.init_params(cfg, seed=0, device=dev)
    mine_p = psh.shard_params(mesh, topt.tree_map(torch.clone, p0))
    out["param_share"] = lt.n_params(mine_p) / lt.n_params(p0)
    b, s_len, tail = spec["B"], spec["S"], spec["valid_tail"]
    x, y, m = dataset.synthetic_cp_dataset(b, s_len, n_class=cfg.vocab_sizes, seed=0)
    m = np.ones_like(m, dtype=np.float32)
    m[b // 2:, tail:] = 0.0
    full = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (x.astype(np.int64), y.astype(np.int64), m))
    mine = pm.shard_batch(mesh, full)
    out["rows"] = int(mine[0].shape[0]) * s_len
    tx = topt.adam(1e-4, grad_clip=3.0)
    routes = {"plain": {"RLMG_FFN_BACKEND": "xla", "RLMG_ATTN_BACKEND": "xla"},
              "f": {"RLMG_FFN_BACKEND": "xla", "RLMG_ATTN_BACKEND": "pallas"}}

    def step(route, dtype, batch, prm0, step_mesh):
        os.environ.update(routes[route])
        scfg = dataclasses.replace(cfg, dtype=dtype)
        prm = topt.tree_map(torch.clone, prm0)
        st = tx.init(prm)
        zero_counts()
        runs0 = tlk.kernel_runs(reset=True) if cuda else (0, 0)
        with _CollectiveCount() as cc:
            grads, (loss, losses) = tpre.agent_grad_step(prm, scfg, *batch, None,
                                                         dp_mesh=step_mesh)
            updates, _ = tx.update(grads, st, prm, mesh=step_mesh)
            prm, _ = tpre.apply_grads(prm, st, tx, grads, step_mesh)
        sync()
        counts, runs = read_counts(), (tlk.kernel_runs() if cuda else runs0)
        if step_mesh is not None:
            prm, grads = psh.gather_params(step_mesh, prm), psh.gather_params(step_mesh, grads)
            updates = psh.gather_params(step_mesh, updates)
        res = [float(loss), losses.cpu(), named_leaves(prm), named_leaves(grads),
               named_leaves(updates)]
        return res, {"counts": counts, "f_runs": list(runs), "collectives": cc.calls}

    def timed(route, dtype, batch, prm0, step_mesh, n=3) -> float:
        os.environ.update(routes[route])
        scfg = dataclasses.replace(cfg, dtype=dtype)
        prm = topt.tree_map(torch.clone, prm0)
        st = tx.init(prm)
        prm, st, _ = tpre.agent_train_step(prm, st, scfg, tx, *batch, None, dp_mesh=step_mesh)
        sync()
        t = time.perf_counter()
        for _ in range(n):
            prm, st, _ = tpre.agent_train_step(prm, st, scfg, tx, *batch, None,
                                               dp_mesh=step_mesh)
        sync()
        return (time.perf_counter() - t) / n * 1e3

    def held(name, route, dtype, tp_out):
        """Rank 0: the one-process step on the same route, and the tp step's
        readings against it; every rank: the losses of its tp group."""
        losses = pm.all_gather_object(mesh, tp_out[0], axis="world")
        out[name]["loss_ranks"] = losses
        dist.barrier()
        if rank == 0:
            ref, info = step(route, dtype, full, p0, None)
            out[name]["single"] = info
            out[name]["loss_single"] = ref[0]
            out[name]["errors"] = step_errors(tp_out, ref)
            del ref
        dist.barrier()

    steps = [(r, "float32") for r in spec["routes"]] + ([("f", "bfloat16")] if spec.get("bf16")
                                                        else [])
    for route, dtype in steps:
        name = f"{route}_{dtype}"
        tp_out, info = step(route, dtype, mine, mine_p, mesh)
        out[name] = {"tp": info, "loss": tp_out[0]}
        held(name, route, dtype, tp_out)
        del tp_out
    if spec.get("control"):
        # the control: torch.distributed.nn's all_reduce (its backward sums
        # the replicated gradient again) in place of reduce_from_tp
        keep = lt.reduce_from_tp
        lt.reduce_from_tp = lambda t, m_: dnf.all_reduce(t, group=m_.group("tp"))
        try:
            c_out, _ = step("f", "float32", mine, mine_p, mesh)
        finally:
            lt.reduce_from_tp = keep
        out["control"] = {}
        held("control", "f", "float32", c_out)
        del c_out
    # times, on the F route at f32: the tp step, one process, dp at the same
    # global batch (a warm step, then the mean of two); over NCCL only
    # (scripts/dp_nccl.py --tp): ranks sharing one card over gloo share its
    # SMs, so their times say nothing of scaling
    dp_rows = pm.shard_batch(dp_mesh, full)
    times = {}
    timed_steps = [s_ for s_ in steps if s_ == ("f", "float32")]
    for route, dtype in timed_steps if spec.get("backend", "gloo") == "nccl" else ():
        key = f"{route}_{dtype}"
        dist.barrier()
        times[f"tp_{key}"] = timed(route, dtype, mine, mine_p, mesh, n=2)
        dist.barrier()
        times[f"dp_{key}"] = timed(route, dtype, dp_rows, p0, dp_mesh, n=2)
        dist.barrier()
        if rank == 0:
            times[f"single_{key}"] = timed(route, dtype, full, p0, None, n=2)
        dist.barrier()
    if times:
        act = torch.zeros((mine[0].shape[0], s_len, cfg.d_model), device=dev)
        red = lambda: ptn.reduce_from_tp(act, mesh)
        red()
        sync()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(10):
            red()
        sync()
        times["allreduce_activation_ms"] = (time.perf_counter() - t) / 10 * 1e3
        times["activation_bytes"] = act.numel() * 4
        del act
    out["times"] = times

    # -- 38. generate_songs under tp: greedy against one process, stochastic
    if spec.get("songs"):
        gcfg = C.GenerateConfig(batch_size=spec["songs"], max_tokens=spec["max_tokens"],
                                bar_production=10 ** 9, greedy=True)
        a_runs = (lambda reset=False: dk4.kernel_runs(reset)) if cuda else (lambda r=False: 0)
        dist.barrier()
        a_runs(True)
        t = time.perf_counter()
        greedy = sampler.generate_songs(p0, cfg, gcfg, mesh=mesh)
        sync()
        ms_tp = (time.perf_counter() - t) * 1e3
        runs_tp = a_runs()
        dist.barrier()
        single, ms_one = None, None
        if rank == 0:
            t = time.perf_counter()
            single = sampler.generate_songs(p0, cfg, gcfg)
            sync()
            ms_one = (time.perf_counter() - t) * 1e3
        single, ms_one = pm.all_gather_object(mesh, (single, ms_one), axis="world")[0]
        gen = {"greedy": greedy, "single": single, "ms_tp": ms_tp, "ms_single": ms_one,
               "a_runs": runs_tp}
        # the first token where the tp songs part from one process's, and the
        # top-2 margins of that field's logits in both, teacher-forced on the
        # common prefix (every rank finds the same place: the songs are
        # equal on all of them)
        first = next(((i, t_, int(np.flatnonzero(a[t_] != o[t_])[0]))
                      for i, (a, o) in enumerate(zip(greedy, single))
                      for t_ in range(min(len(a), len(o))) if not np.array_equal(a[t_], o[t_])),
                     None)
        gen["first_difference"] = first
        if first is not None:
            i, t_, f = first
            shard = psh.shard_tree(mesh, p0)
            prefix = torch.as_tensor(single[i][:t_], dtype=torch.int32, device=dev)[None]
            st_tp = lt.init_decode_state(cfg, 1, device=dev, mesh=mesh)
            st_one = lt.init_decode_state(cfg, 1, device=dev)
            for k in range(t_):
                h_tp, st_tp = lt.decode_step(shard, cfg, prefix[:, k], st_tp, mesh=mesh)
                h_one, st_one = lt.decode_step(p0, cfg, prefix[:, k], st_one)
            off = int(sum(cfg.vocab_sizes[:f]))
            margins = []
            for lg in (lt.head_logits(shard, cfg, h_tp, mesh), lt.head_logits(p0, cfg, h_one)):
                top = torch.topk(lg[0, off:off + cfg.vocab_sizes[f]].float(), 2)
                margins.append((top.indices.tolist(), float(top.values[0] - top.values[1])))
            gen["margins"] = margins
        stoch = dataclasses.replace(gcfg, greedy=False, seed=5, max_tokens=32)
        gen["stochastic"] = sampler.generate_songs(p0, cfg, stoch, mesh=mesh)
        out["generate"] = gen
    return out


def tp_gate_failures(res: list, n_layer: int, vocab_sizes, spec: dict) -> list:
    """Phases 36-38's gates over every rank's ``tp_rank`` readings; the
    failures, each a line ([] when every gate holds)."""
    fails = []
    r0 = res[0]
    tp = spec["tp"]
    steps = [f"{r}_float32" for r in spec["routes"]] + (["f_bfloat16"] if spec.get("bf16")
                                                        else [])
    for name in steps:
        want = [0] * 6 + ([n_layer, n_layer] if name.startswith("f_") else [0, 0]) + [0, 0]
        for r in res:
            if r[name]["tp"]["counts"] != want:
                fails.append(f"rank {r['rank']} {name}: launches (C, D, E, F, G fwd/bwd) "
                             f"{r[name]['tp']['counts']}, expected {want}")
        if r0[name]["single"]["counts"] != want:
            fails.append(f"one process {name}: launches {r0[name]['single']['counts']}, "
                         f"expected {want}")
        losses = r0[name]["loss_ranks"]
        for g in range(len(losses) // tp):
            grp = losses[g * tp:(g + 1) * tp]
            if len(set(grp)) != 1 or not all(math.isfinite(v) for v in grp):
                fails.append(f"{name}: losses of tp group {g} {grp}")
        bad = step_gate_failures(r0[name]["errors"],
                                 BF16_STEP_GATES if "bfloat16" in name else STEP_GATES)
        if bad:
            fails.append(f"{name}: tp step against one process: {bad}")
    for r in res:
        if not abs(r["param_share"] - 1 / tp) < 0.05:
            fails.append(f"rank {r['rank']} holds {r['param_share']:.3f} of the parameters")
    if spec.get("control") and not step_gate_failures(r0["control"]["errors"]):
        fails.append("the control (torch.distributed.nn's all_reduce) passes the step gate")
    if "generate" in r0:
        g0 = r0["generate"]
        for r in res:
            g = r["generate"]
            if g["a_runs"] != 0:
                fails.append(f"rank {r['rank']}: kernel A ran {g['a_runs']} times under tp")
            for key in ("greedy", "stochastic"):
                if len(g[key]) != len(g0[key]) or any(
                        not np.array_equal(a, b) for a, b in zip(g0[key], g[key])):
                    fails.append(f"{key}: rank {r['rank']} returned another list than rank 0")
        if len(g0["greedy"]) != spec["songs"] or any(
                len(s) != spec["max_tokens"] + 1 for s in g0["greedy"]):
            fails.append(f"greedy: {[len(s) for s in g0['greedy']]} tokens a song")
        seed_row = np.asarray((0, 0, 1, 0, 0, 0))
        for i, song in enumerate(g0["stochastic"]):
            if (len(song) < 2 or not np.array_equal(song[0], seed_row)
                    or (song < 0).any() or (song >= np.asarray(vocab_sizes)).any()):
                fails.append(f"stochastic song {i} is not a valid song")
        if g0["first_difference"] is not None:
            # a flip of the row-parallel sums' order is legitimate only at a
            # near-tie: one process's top-2 margin there under 1e-3
            margin = g0["margins"][1][1]
            if not margin < 1e-3:
                fails.append(f"greedy songs part from one process's at {g0['first_difference']} "
                             f"with one process's top-2 margin {margin:.3e}")
    return fails


def tp_run(cfg, smi_line, *, backend: str = "gloo", meshes=None) -> dict:
    """Phases 36-38: the (dp, tp) meshes of ``tp_rank`` at ``cfg``'s width,
    over gloo all on card 0 (36: tp = 2, B = 8 x 512, both f32 routes and the
    control, then 38: generate_songs 8 greedy songs of 256 tokens and a
    stochastic run; 37: dp = 2 x tp = 2, B = 16 x 512, the F route at f32
    and bf16), or over nccl a card each (scripts/dp_nccl.py --tp); prints
    the readings, fails on ``tp_gate_failures``, returns each mesh's rank-0
    readings."""
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    base = {"cfg": dict(vocab_sizes=cfg.vocab_sizes), "S": 512, "valid_tail": 100}
    if meshes is None:
        meshes = [dict(base, phase=36, dp=1, tp=2, B=8, routes=("plain", "f"), control=True,
                       songs=8, max_tokens=256),
                  dict(base, phase=37, dp=2, tp=2, B=16, routes=("f",), bf16=True)]
    cards = "all on card 0" if backend == "gloo" else "a card each"
    found = {}
    for spec in meshes:
        spec = dict(spec, backend=backend)
        world = spec["dp"] * spec["tp"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()        # the ranks are processes of their own
        t = time.perf_counter()
        res = pm.launch(tp_rank, world, (spec,), backend=backend, timeout_s=600)
        wall = time.perf_counter() - t
        r0 = res[0]
        tag = f"[tp] {spec['phase']}: dp={spec['dp']} x tp={spec['tp']} over {backend}, {cards}"
        print(f"{tag} ({smi_line}): {wall:.1f}s with the ranks' start; rows a rank "
              f"{r0['rows']}, parameters a rank {r0['param_share']:.3f} of the whole", flush=True)
        for name in [k for k in r0 if k.endswith(("_float32", "_bfloat16"))] + (
                ["control"] if "control" in r0 else []):
            e = r0[name]["errors"]
            info = r0[name].get("tp", {})
            print(f"{tag} {name}: loss tp {r0[name]['loss_ranks']} one process "
                  f"{r0[name]['loss_single']:.7f}; against one process: loss {e['loss']:.2e}, "
                  f"gradients {e['grads'][0]:.3e} ({e['grads'][1]}), params {e['params'][0]:.3e},"
                  f" updates {e['updates'][0]:.3e}; launches (C, D, E, F, G fwd/bwd) a rank "
                  f"{[r[name]['tp']['counts'] for r in res] if info else '-'}, F's own runs "
                  f"{info.get('f_runs')}; collectives a step (calls, elements) "
                  f"{info.get('collectives')}", flush=True)
        tm = r0["times"]
        if tm:
            print(f"{tag}: ms a step {{tp, dp at the same global batch, one process}}: "
                  + "; ".join(f"{k[3:]} {tm[k]:.1f} / {tm['dp_' + k[3:]]:.1f} / "
                              f"{tm.get('single_' + k[3:], float('nan')):.1f} (rank 0; tp on "
                              f"the ranks {[round(r['times'][k], 1) for r in res]})"
                              for k in tm if k.startswith("tp_"))
                  + f"; one all-reduce of an activation ({tm['activation_bytes'] / 2**20:.1f} "
                  f"MiB) over tp {tm['allreduce_activation_ms']:.2f} ms ({smi_line})",
                  flush=True)
        if "generate" in r0:
            g = r0["generate"]
            print(f"[tp] 38: generate_songs under tp={spec['tp']}, {len(g['greedy'])} greedy "
                  f"songs of {spec['max_tokens']} tokens, f32 weights: {g['ms_tp']:.1f} ms on "
                  f"the ranks, {g['ms_single']:.1f} ms in one process ({smi_line}); kernel A's "
                  f"runs under tp {[r['generate']['a_runs'] for r in res]}; first token apart "
                  f"from one process's (song, token, field) {g['first_difference']}"
                  + (f", top-2 (ids, margin) tp {g['margins'][0]} one process "
                     f"{g['margins'][1]}" if g["first_difference"] else "")
                  + f"; stochastic: {[len(s) for s in g['stochastic']]} tokens", flush=True)
        fails = tp_gate_failures(res, cfg.n_layer, cfg.vocab_sizes, spec)
        check(not fails, f"tp over {backend}, phase {spec['phase']}: " + "; ".join(fails))
        found[spec["phase"]] = {"res": [{k: v for k, v in r.items() if k != "generate"}
                                        for r in res], "generate": r0.get("generate")}
    return found


# -- the RL commands on the (dp, tp) mesh: phases 39-41 ------------------------
# the slice's routes: kernel F in every agent, actor and critic layer; kernel
# E in the Longformer's layers wherever the JAX dispatch takes the banded
# kernel (S > 1024 and S > 2 x window: the discriminator on 4 x 2048, not
# on the commands' 50-token states, which take the dense band)
RL_ROUTES = {"RLMG_ATTN_BACKEND": "pallas", "RLMG_WINDOW_BACKEND": "pallas"}
# the mesh's step against one process: the loss and every gradient within
# check_step's limits; the parameters and Adam updates are printed, not
# gated.  The card's disc_long reading (NVIDIA H100 80GB HBM3, 700 W): the
# gradients 7.753e-05 of their leaf's magnitude, inside the gate, the
# parameters 1.910e-04 and the updates 1.938e-03, above check_step's 1e-4
# and 1e-3.  Adam's first step moves an element by u = lr g / (|g| + eps),
# so its error is about lr eps |dg| / (|g| + eps)^2: where |g| is near eps
# (step_errors reads every element above 1e-3 of its leaf's largest |g|,
# and a leaf's gradients can be small) the gradient's rounding is amplified
# in u.  The updates' worst leaf was /pos_emb (printed since); which of its
# elements moved was not read.
RL_STEP_GATES = {k: STEP_GATES[k] for k in ("loss", "grads")}
# leaves whose gradient is 0 in exact arithmetic (the softmax removes the key
# bias, the train-mode BatchNorm the first score layer's bias): both sides
# hold rounding noise there, printed and left out of the step gates
RL_ZERO_GRADS = ("/layers/wk/b", "/score/l1/b")
RL_RUNS = "(F fwd, F bwd, E fwd, E bwd, G fwd, G bwd, D fwd, D bwd)"
# the split discriminator epoch (item 9(b3)): airl.disc_epoch(dp_rows=True)
# at the discriminator's width on 4 minibatches of 100 x 50 states, each
# split over dp; in 40b on kernel D's route (the Longformer's fused tail,
# forced at the rank's 2500 rows; its "pallas" route is the composition, as
# in JAX, so G runs in no discriminator layer)
DISC_SPLIT = {"minibatches": 4, "rows": 100, "states": 50}
DISC_SPLIT_D_ROUTE = {"RLMG_FFN_BACKEND": "pallas-tail"}


def rl_runs(cuda: bool, reset: bool = False) -> list:
    """``RL_RUNS`` on this process: F's and G's forwards and F's backward as
    the kernels count their runs on the card (graph replays included), E's,
    G's backward and D's as their wrappers count their launches (eager on
    these paths); ``reset`` zeroes them after the read."""
    from reinforcement_learning_in_music_generation_torch.ops import (
        ffn_block as tfb, linear_attention_kernel as tlk, window_attention_kernel as twk)
    band, g, d = twk.window_attention_band, tfb.ffn_block, tfb.attn_tail_block
    out = [*(tlk.kernel_runs(reset) if cuda else (0, 0)), band.launches_fwd,
           band.launches_bwd, tfb.ffn_kernel_runs(reset) if cuda else 0, g.launches_bwd,
           d.launches_fwd, d.launches_bwd]
    if reset:
        band.launches_fwd = band.launches_bwd = g.launches_bwd = 0
        d.launches_fwd = d.launches_bwd = 0
    return out


def rl_rank(spec: dict) -> dict:
    """Phases 39-40 on one rank of a (dp, tp) mesh of ``spec["dp"]`` x
    ``spec["tp"]`` ranks (``rl_run`` spawns them: over gloo every rank on
    card 0; over nccl, ``spec["backend"]``, rank r on card r), at the
    flagship width (``spec["n_layer"]``, default 12; the discriminator and
    reward model 2 fewer) under ``RL_ROUTES``, dropout 0, lr 1e-4 (so that
    one Adam step shows at the parameter gate).  ``spec["steps"]`` names
    what runs: "dqn" (one dqn.update on a batch of 30 x 50), "control" (the
    same with each rank's own MSE mean summed over dp: control (i)), "disc"
    (one AIRL disc_step on 100 x 50, the rows whole on every rank), "disc_long"
    (the same on 4 x 2048, where kernel E runs), "rollout" (one DQN rollout
    song, 50 episodes, eager under tp), "ppo" (one PPO rollout song of 30
    episodes, then one update_policy_step on its transitions split over dp),
    "disc_split" (one disc_epoch with each minibatch split over dp,
    ``DISC_SPLIT``; under ``spec["disc_route"]`` where given, and with
    ``spec["disc_control"]`` the same epoch with each rank's own BatchNorm
    statistics, the control).
    ``spec["ffn"] = "pallas"`` adds RLMG_FFN_BACKEND=pallas (kernel G, at
    tp = 1 only).  Each on the rank's rows and tp shards; rank 0 also runs it in one
    process and holds the mesh's readings against it (``step_errors``).
    Every rank digests its gathered parameters, so that the dp ranks can be
    held bit-equal.  ``spec["device"] = "cpu"`` rehearses on the kernels'
    plain versions."""
    import torch.distributed as dist
    from reinforcement_learning_in_music_generation_torch import config as C
    from reinforcement_learning_in_music_generation_torch.data import dataset
    from reinforcement_learning_in_music_generation_torch.models import linear_transformer as lt
    from reinforcement_learning_in_music_generation_torch.models import longformer as lf
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    from reinforcement_learning_in_music_generation_torch.parallel import sharding as psh
    from reinforcement_learning_in_music_generation_torch.rl import airl, dqn, env, ppo
    from reinforcement_learning_in_music_generation_torch.train import optim as topt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k in ("RLMG_FFN_BACKEND", "RLMG_ATTN_BACKEND", "RLMG_WINDOW_BACKEND", "RLMG_FFN_MIN_ROWS"):
        os.environ.pop(k, None)
    os.environ.update(RL_ROUTES)
    if spec.get("ffn"):
        os.environ["RLMG_FFN_BACKEND"] = spec["ffn"]
    dp, tp = spec["dp"], spec["tp"]
    world = dp * tp
    if spec.get("backend", "gloo") == "nccl":
        mesh = pm.make_mesh(dp, tp)
        dev = mesh.device
    else:
        dev = torch.device(spec.get("device", "cuda:0"))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = pm.make_mesh(dp, tp, devices=[dev] * world, backend="gloo")
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rank = mesh.rank
    out = {"rank": rank, "dp_index": mesh.dp_index, "tp_index": mesh.tp_index, "steps": {}}
    clone = lambda tree: topt.tree_map(torch.clone, tree)
    n_layer = spec.get("n_layer", 12)

    def mine(tree, step_mesh):
        """A copy of a whole tree, or this rank's tp shards of it."""
        return clone(tree) if step_mesh is None else psh.shard_params(step_mesh, clone(tree))

    def readings(loss, losses, prm, st, tx, step_mesh, zero=()):
        """(``step_errors``' readings, the zero leaves' largest |g|, the whole
        parameters' digest) of one step: the gradients from Adam's first
        moment ((1 - b1) g after one step from zeros) and the update
        recomputed from them; trees gathered under a mesh."""
        g = topt.tree_map(lambda m_: m_ / (1.0 - tx.b1), st.mu)
        u, _ = tx.update(g, tx.init(g))
        if step_mesh is not None:
            prm, g, u = (psh.gather_params(step_mesh, t_) for t_ in (prm, g, u))
        p_, g_, u_ = named_leaves(prm), named_leaves(g), named_leaves(u)
        noise = max((g_[k].abs().max().item() for k in zero if k in g_), default=0.0)
        keep = lambda t_: {k: v for k, v in t_.items() if k not in zero}
        return ([loss, losses, keep(p_), keep(g_), keep(u_)], noise,
                tree_digest(topt.tree_leaves(prm)))

    def timed(fn, *a):
        rl_runs(cuda, reset=True)
        sync()
        t = time.perf_counter()
        res = fn(*a)
        sync()
        return res, (time.perf_counter() - t) * 1e3, rl_runs(cuda)

    def held(name, fn):
        """``fn(mesh)`` on every rank, then ``fn(None)`` in one process on
        rank 0: the mesh's step against one process's."""
        got, ms, counted = timed(fn, mesh)
        step = {"runs": counted, "ms": ms, "loss": got[0][0], "noise": got[1],
                "digests": pm.all_gather_object(mesh, got[2], axis="world")}
        dist.barrier()
        if rank == 0:
            one, ms1, _ = timed(fn, None)
            step.update(ms_single=ms1, loss_single=one[0][0], noise_single=one[1],
                        errors=step_errors(got[0], one[0]))
            if name.startswith("disc"):
                # the same step again in this process: the leaves whose
                # parameters after it are not bit-equal to the first run's
                again = fn(None)[0][2]
                step["repeat_differs"] = [k for k, v in one[0][2].items()
                                          if not torch.equal(v, again[k])]
                del again
            del one
        del got
        dist.barrier()
        out["steps"][name] = step

    vocab = (56, 135, 18, 87, 18, 25)                # dqn-train's six fields
    qcfg = C.agent_config(vocab, n_layer=n_layer, dropout=0.0)
    dqcfg = C.DQNConfig(lr=1e-4)
    b_q, s_q, n_act = 30, dqcfg.n_states, dqcfg.n_actions
    xs, ys, ms_ = (torch.from_numpy(a).to(dev) for a in
                   dataset.synthetic_cp_dataset(b_q, 512, n_class=vocab, seed=0))
    g0 = torch.Generator(device=dev)
    g0.manual_seed(1)
    st_rows = xs[:, 100:100 + s_q].int().contiguous()
    qbatch = {"state": st_rows, "action": ys[:, 200:200 + n_act].int(),
              "reward": torch.rand((b_q, 1), generator=g0, device=dev),
              "next_state": torch.cat([st_rows[:, :n_act], ys[:, 200:200 + n_act].int()], 1),
              "done": torch.zeros((b_q, 1), dtype=torch.int32, device=dev)}
    qebatch = {"state": ys[:, :s_q].int(), "next_state": ys[:, s_q:2 * s_q].int(),
               "mask_next_state": ms_[:, 1:s_q + 1].float()}
    q0 = lt.init_params(qcfg, seed=0, device=dev)

    def dqn_step(step_mesh, rank_local=False):
        st = dqn.init_state(qcfg, dqcfg, mine(q0, step_mesh))
        tx = dqn.make_optimizer(dqcfg)
        keep = dqn.batch_mean
        if rank_local:
            dqn.batch_mean = lambda x, mesh_=None: torch.mean(x)
        try:
            # the whole batches: the update keeps the rank's dp rows
            st, m = dqn.update(st, qcfg, dqcfg, tx, qbatch, qebatch, None, step_mesh)
        finally:
            dqn.batch_mean = keep
        return readings(float(m["total"]), torch.stack([m["mse"], m["ce"]]).cpu(),
                        st.eval_params, st.opt_state, tx, step_mesh)

    wcfg = C.airl_discriminator_config(vocab, n_layer=max(1, n_layer - 2), dropout=0.0)
    acfg = C.AIRLConfig(lr=1e-4)
    w0 = lf.init_params(wcfg, seed=1, device=dev)

    def disc_step(b, s, seed):
        e_, a_ = (torch.from_numpy(dataset.synthetic_cp_dataset(b, s, n_class=vocab,
                                                                seed=seed + i)[0]).to(dev).int()
                  for i in range(2))
        m_ = torch.ones((b, s), device=dev)
        m_[b // 2:, s - s // 10:] = 0.0

        def fn(step_mesh):
            prm = mine(w0, step_mesh)
            tx = airl.make_optimizer(acfg)
            st = airl.AIRLState(prm, lf.init_state(wcfg, device=dev), tx.init(prm))
            st, m = airl.disc_step(st, wcfg, tx, e_, m_, a_, None, step_mesh)
            return readings(float(m["global_loss"]), torch.stack(
                [m[k] for k in ("expert_loss", "agent_loss", "ce_loss")]).cpu(), st.params,
                st.opt_state, tx, step_mesh, RL_ZERO_GRADS)
        return fn

    def margins(logits_fn, state, pos, field, cfg_):
        """The top-2 (ids, margin) of one action field's logits at one of
        the last n_actions positions, teacher-forced on ``state``."""
        lg = logits_fn(state)[0, -n_act + pos]
        off = int(sum(cfg_.vocab_sizes[:field]))
        top = torch.topk(lg[off:off + cfg_.vocab_sizes[field]].float(), 2)
        return top.indices.tolist(), float(top.values[0] - top.values[1])

    def first_apart(acts, ref, ref_states, prm, whole, cfg_, logits):
        """The first (episode, position, field) where ``acts`` part from one
        process's ``ref``, with both sides' top-2 margins there (the mesh's
        a collective of the rank's tp group, whose ranks hold the same
        actions)."""
        diff = np.argwhere(acts != ref)
        if not len(diff):
            return None
        ep, pos, f = (int(v) for v in diff[0])
        state = torch.as_tensor(ref_states[ep:ep + 1], device=dev)
        return {"at": (ep, pos, f),
                "margins": (margins(lambda s_: logits(prm, s_, mesh), state, pos, f, cfg_),
                            margins(lambda s_: logits(whole, s_, None), state, pos, f, cfg_))}

    def agent_logits(prm, s_, m_):
        return lt.head_logits(prm, qcfg, lt.forward_hidden(prm, qcfg, s_, dp_mesh=m_), m_)

    steps = spec["steps"]
    if "dqn" in steps:
        held("dqn", dqn_step)
    if "control" in steps:
        held("control", lambda m_: dqn_step(m_, rank_local=m_ is not None))
    if "disc" in steps:
        held("disc", disc_step(acfg.batch_size, s_q, 5))
    if "disc_long" in steps:
        held("disc_long", disc_step(4, 2048, 7))
    if "disc_split" in steps:
        out["steps"]["disc_split"] = disc_split(spec, mesh, wcfg, acfg, w0, mine, readings,
                                                timed, vocab, dev)
    if "rollout" in steps:
        prm = mine(q0, mesh)
        song = (xs[0], ys[0], ms_[0])
        (a_t, _), ms, counted = timed(lambda: env.dqn_rollout_song(prm, qcfg, *song, mesh=mesh))
        acts = a_t["action"].cpu().numpy()
        single = None
        dist.barrier()
        if rank == 0:
            (a_o, _), ms1, _ = timed(lambda: env.dqn_rollout_song(clone(q0), qcfg, *song))
            single = (a_o["action"].cpu().numpy(), a_o["state"].cpu().numpy(), ms1)
        ref, ref_states, ms1 = pm.all_gather_object(mesh, single, axis="world")[0]
        out["steps"]["rollout"] = {
            "runs": counted, "ms": ms, "ms_single": ms1, "episodes": int(acts.shape[0]),
            "actions_equal": bool((acts == ref).all()),
            "apart": first_apart(acts, ref, ref_states, prm, q0, qcfg, agent_logits)}
        del prm
    if "ppo" in steps:
        pvocab = (49, 19, 19, 89, 67, 25)
        pcfgs = (C.actor_config(pvocab, n_layer=n_layer, dropout=0.0),
                 C.critic_config(pvocab, n_layer=n_layer, dropout=0.0),
                 C.ppo_reward_config(pvocab, n_layer=max(1, n_layer - 2), dropout=0.0))
        pcfg = C.PPOConfig(lr=1e-4)
        p0 = ppo.init_state(*pcfgs, pcfg, seed=0, device=dev)
        song = tuple(torch.from_numpy(a[0]).to(dev) for a in
                     dataset.synthetic_cp_dataset(1, 512, n_class=pvocab, seed=4))

        def fresh(step_mesh):
            trees = [mine(t_, step_mesh) for t_ in p0[:3]]
            txs = ppo.make_optimizers(pcfg)
            return ppo.PPOState(*trees, txs[0].init(trees[0]), txs[1].init(trees[1])), txs

        def actor_logits(prm, s_, m_):
            return lt.head_logits(prm, pcfgs[0],
                                  lt.forward_hidden(prm, pcfgs[0], s_, dp_mesh=m_), m_)

        def step(state, txs, a_t, e_t, step_mesh):
            ret = ppo.calculate_returns(a_t["reward"][:, 0], pcfg.discount)
            adv = ppo.calculate_advantages(ret, a_t["value"])
            a_s, e_s, adv_s, ret_s = (a_t, e_t, adv, ret) if step_mesh is None else \
                pm.shard_batch(step_mesh, (a_t, e_t, adv, ret))
            state, m = ppo.update_policy_step(state, pcfgs, pcfg, txs, a_s, e_s, adv_s, ret_s,
                                              step_mesh)
            pl = torch.stack([m["policy_loss"]]).cpu()
            return (readings(float(m["actor_loss"]), pl, state.actor_params, state.actor_opt,
                             txs[0], step_mesh),
                    readings(float(m["value_loss"]), pl, state.critic_params,
                             state.critic_opt, txs[1], step_mesh))

        state, txs = fresh(mesh)
        (a_t, e_t), ms_roll, roll_runs = timed(
            lambda: ppo.rollout_song(state, pcfgs, *song, mesh=mesh))
        single = None
        dist.barrier()
        if rank == 0:
            st1, _ = fresh(None)
            (a_o, _), ms1, _ = timed(lambda: ppo.rollout_song(st1, pcfgs, *song))
            single = ({k: a_o[k].cpu().numpy() for k in ("action", "value", "reward",
                                                         "log_action", "state")}, ms1)
            del st1
        ref, ms_roll1 = pm.all_gather_object(mesh, single, axis="world")[0]
        got = {k: a_t[k].cpu().numpy() for k in ("action", "value", "reward", "log_action")}
        roll = {"runs": roll_runs, "ms": ms_roll, "ms_single": ms_roll1,
                "actions_equal": bool((got["action"] == ref["action"]).all()),
                "apart": first_apart(got["action"], ref["action"], ref["state"],
                                     state.actor_params, p0.actor_params, pcfgs[0],
                                     actor_logits),
                **{f"{k}_share": float(np.abs(got[k] - ref[k]).max() /
                                       max(np.abs(ref[k]).max(), 1e-30))
                   for k in ("value", "reward", "log_action")}}
        (r_a, r_c), ms_upd, upd_runs = timed(step, state, txs, a_t, e_t, mesh)
        rows = pm.shard_rows(mesh, pcfg.episodes)
        upd = {"runs": upd_runs, "ms": ms_upd, "rows": rows.stop - rows.start,
               "loss": (r_a[0][0], r_c[0][0]),
               "digests": pm.all_gather_object(mesh, (r_a[2], r_c[2]), axis="world")}
        dist.barrier()
        if rank == 0:
            st1, txs1 = fresh(None)
            (o_a, o_c), ms1, _ = timed(step, st1, txs1, a_t, e_t, None)
            upd.update(ms_single=ms1, loss_single=(o_a[0][0], o_c[0][0]),
                       errors=(step_errors(r_a[0], o_a[0]), step_errors(r_c[0], o_c[0])))
            del st1, o_a, o_c
        dist.barrier()
        out["steps"]["ppo_rollout"], out["steps"]["ppo"] = roll, upd
    return out


def disc_split(spec, mesh, wcfg, acfg, w0, mine, readings, timed, vocab, dev) -> dict:
    """Phase 40 / 40b's split discriminator epoch (``DISC_SPLIT``) on every
    rank, then in one process on rank 0, under ``spec.get("disc_route")``:
    the runs, ms, loss and digests of the mesh's epoch, its errors against
    one process's (``step_errors``: the loss, and Adam's first moment after
    the epoch in place of the gradients), and with ``spec["disc_control"]``
    the control's errors (the score head's BatchNorm on each rank's rows)."""
    import torch.distributed as dist
    from reinforcement_learning_in_music_generation_torch.data import dataset
    from reinforcement_learning_in_music_generation_torch.models import longformer as lf
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    from reinforcement_learning_in_music_generation_torch.rl import airl
    n = DISC_SPLIT["minibatches"] * DISC_SPLIT["rows"]
    s = DISC_SPLIT["states"]
    e_, a_ = (torch.from_numpy(dataset.synthetic_cp_dataset(n, s, n_class=vocab,
                                                            seed=11 + i)[0]).to(dev).int()
              for i in range(2))
    m_ = torch.ones((n, s), device=dev)
    m_[::3, s - s // 5:] = 0.0

    def fn(step_mesh):
        prm = mine(w0, step_mesh)
        tx = airl.make_optimizer(acfg)
        st = airl.AIRLState(prm, lf.init_state(wcfg, device=dev), tx.init(prm))
        st, m = airl.disc_epoch(st, wcfg, tx, e_, m_, a_, None, DISC_SPLIT["rows"], step_mesh,
                                dp_rows=True)
        return readings(float(m["global_loss"]), torch.stack(
            [m[k] for k in ("expert_loss", "agent_loss", "ce_loss")]).cpu(), st.params,
            st.opt_state, tx, step_mesh, RL_ZERO_GRADS)

    keep = {k: os.environ.get(k) for k in ("RLMG_FFN_BACKEND", "RLMG_ATTN_BACKEND",
                                           "RLMG_WINDOW_BACKEND")}
    route = spec.get("disc_route")
    if route is not None:
        for k in keep:
            os.environ.pop(k, None)
        os.environ.update(route)
    try:
        got, ms, counted = timed(fn, mesh)
        step = {"runs": counted, "ms": ms, "loss": got[0][0], "noise": got[1],
                "digests": pm.all_gather_object(mesh, got[2], axis="world")}
        ctl = None
        if spec.get("disc_control"):
            head = lf._score_head
            lf._score_head = lambda p_, s_, h, train, dp_mesh=None: head(p_, s_, h, train)
            try:
                ctl = fn(mesh)
            finally:
                lf._score_head = head
        dist.barrier()
        if mesh.rank == 0:
            one, ms1, _ = timed(fn, None)
            step.update(ms_single=ms1, loss_single=one[0][0], noise_single=one[1],
                        errors=step_errors(got[0], one[0]))
            if ctl is not None:
                step["control_errors"] = step_errors(ctl[0], one[0])
                step["control_loss"] = ctl[0][0]
            del one
        del got, ctl
        dist.barrier()
    finally:
        for k, v in keep.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
    return step


def rl_gate_failures(res: list, spec: dict) -> list:
    """Phases 39-40's gates over every rank's ``rl_rank`` readings; the
    failures, each a line ([] when every gate holds)."""
    fails = []
    L = spec.get("n_layer", 12)
    Lw = max(1, L - 2)
    r0 = res[0]["steps"]
    # RL_RUNS on each rank: three agent forwards and two backwards an update
    # (eval, target, CE); a rollout episode one forward; the discriminator
    # at 4 x 2048 takes E in each layer of its three forwards (the expert's
    # and the agent's scores, the token CE) and their backwards; at 50
    # tokens the dense band; a PPO episode an actor and a critic forward, an
    # update two actor forwards and one critic forward, each with its
    # backward.  Under spec["ffn"] = "pallas" G runs wherever F does (the
    # agent's, actor's and critic's layers), else nowhere.  D runs only in
    # the split discriminator epoch on spec["disc_route"]: each layer of its
    # three forwards a minibatch and their backwards
    f = {"dqn": [3 * L, 2 * L], "control": [3 * L, 2 * L], "disc": [0, 0], "disc_long": [0, 0],
         "rollout": [50 * L, 0], "ppo_rollout": [30 * 2 * L, 0], "ppo": [3 * L, 3 * L],
         "disc_split": [0, 0]}
    e = {k: [3 * Lw, 3 * Lw] if k == "disc_long" else [0, 0] for k in f}
    nd = 3 * Lw * DISC_SPLIT["minibatches"] if spec.get("disc_route") else 0
    d = {k: [nd, nd] if k == "disc_split" else [0, 0] for k in f}
    want = {k: f[k] + e[k] + (f[k] if spec.get("ffn") == "pallas" else [0, 0]) + d[k]
            for k in f}
    for name in r0:
        for r in res:
            if r["steps"][name]["runs"] != want[name]:
                fails.append(f"rank {r['rank']} {name}: runs {RL_RUNS} "
                             f"{r['steps'][name]['runs']}, expected {want[name]}")
    for name in ("dqn", "disc", "disc_long", "disc_split"):
        if name in r0:
            bad = step_gate_failures(r0[name]["errors"], RL_STEP_GATES)
            if bad:
                fails.append(f"{name}: the mesh's step against one process: {bad}")
            if len(set(r0[name]["digests"])) != 1:
                fails.append(f"{name}: the ranks' parameters differ after the step")
            losses = {r["steps"][name]["loss"] for r in res}
            if len(losses) != 1 or not all(math.isfinite(v) for v in losses):
                fails.append(f"{name}: losses on the ranks {sorted(losses)}")
    if "control" in r0 and not step_gate_failures(r0["control"]["errors"], RL_STEP_GATES):
        fails.append("control (i), each rank's own MSE mean, passes the step gate")
    if spec.get("disc_control") and not step_gate_failures(
            r0["disc_split"]["control_errors"], RL_STEP_GATES):
        fails.append("the split epoch's control, each rank's own BatchNorm statistics, passes "
                     "the step gate")
    for name in ("rollout", "ppo_rollout"):
        for r in res if name in r0 else ():
            s = r["steps"][name]
            if s["apart"] is not None:
                # an argmax flip is legitimate only at a near-tie: one
                # process's top-2 margin there under 1e-3
                margin = s["apart"]["margins"][1][1]
                if not margin < 1e-3:
                    fails.append(f"rank {r['rank']} {name}: actions part from one process's "
                                 f"at {s['apart']['at']} with one process's top-2 margin "
                                 f"{margin:.3e}")
            elif not s["actions_equal"]:
                fails.append(f"rank {r['rank']} {name}: actions differ from one process's")
    if "ppo_rollout" in r0:
        s = r0["ppo_rollout"]
        for k in ("value", "reward", "log_action"):
            if s["apart"] is None and not s[f"{k}_share"] <= 1e-4:
                fails.append(f"ppo rollout: {k} {s[f'{k}_share']:.3e} of its magnitude from "
                             "one process's")
    if "ppo" in r0:
        for tag, e in zip(("actor", "critic"), r0["ppo"]["errors"]):
            bad = step_gate_failures(e, RL_STEP_GATES)
            if bad:
                fails.append(f"ppo {tag}: the mesh's step against one process: {bad}")
        if len(set(r0["ppo"]["digests"])) != 1:
            fails.append("ppo: the ranks' actor or critic parameters differ after the step")
    return fails


def tree_digest(leaves) -> str:
    """SHA-1 of the tensors' bytes, in order."""
    import hashlib
    h = hashlib.sha1()
    for leaf in leaves:
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def rl_cli_rank(argv: list, world: int, device=None) -> dict:
    """One rank of an RL command on a mesh of ``world`` ranks: over gloo with
    every rank on ``device`` (phase 41), or with ``device`` None over the
    process group's NCCL, rank r on card r (scripts/dp_nccl.py --rl).  The
    command runs on the rank's mesh as ``apps/cli.py``'s rank entry runs it
    (rank 0 alone prints); then every rank's digest of each whole tree the
    command ends with and of its generator, in rank order (collectives),
    and this rank's ``rl_runs``."""
    import contextlib
    from reinforcement_learning_in_music_generation_torch.apps import cli
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    from reinforcement_learning_in_music_generation_torch.parallel import sharding as psh
    from reinforcement_learning_in_music_generation_torch.train import optim as topt
    os.environ.update(RL_ROUTES)
    args = cli.build_parser().parse_args(argv)
    if device is None:
        mesh = pm.make_mesh(args.dp, args.tp)
    else:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = pm.make_mesh(args.dp, args.tp, devices=[dev] * world, backend="gloo")
    cuda = mesh.device.type == "cuda"
    rl_runs(cuda, reset=True)
    with open(os.devnull, "w") as null, \
            contextlib.redirect_stdout(sys.stdout if mesh.rank == 0 else null):
        res = args.fn(args, mesh=mesh)
    runs = rl_runs(cuda)
    leaves = {k: [v.get_state()] if isinstance(v, torch.Generator) else
              topt.tree_leaves(psh.gather_params(mesh, v)) for k, v in res.pop("final").items()}
    res["digests"] = {k: pm.all_gather_object(mesh, tree_digest(v), axis="world")
                      for k, v in leaves.items()}
    return {"res": res, "runs": runs}


RL_CLI = {"dqn-train": ["--synthetic", "--synthetic-songs", "4", "--seq-len", "512",
                        "--layers", "4", "--batch-size", "30", "--buffer-size", "100",
                        "--songs", "4", "--max-updates", "2", "--ckpt-epoch-gate", "0",
                        "--disc-epochs", "1"],
          "ppo-train": ["--synthetic", "--synthetic-songs", "2", "--seq-len", "512",
                        "--layers", "4", "--songs", "2", "--ppo-steps", "2"]}


def rl_cli_run(smi_line, meshes, device="cuda:0") -> dict:
    """Phase 41: ``cli dqn-train`` and ``cli ppo-train`` on gloo meshes on
    ``device`` (``meshes``: {command: (dp, tp)}), and each in one process
    with the same flags; the checkpoints loaded whole."""
    from reinforcement_learning_in_music_generation_torch import config as C
    from reinforcement_learning_in_music_generation_torch.apps import cli
    from reinforcement_learning_in_music_generation_torch.models import linear_transformer as lt
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    from reinforcement_learning_in_music_generation_torch.utils.checkpoint import load_checkpoint
    found = {}
    keep = {k: os.environ.get(k) for k in RL_ROUTES}
    with tempfile.TemporaryDirectory() as tmp:
        for cmd, (dp, tp) in meshes.items():
            d = lambda *p: os.path.join(tmp, cmd, *p)
            argv = [cmd, *RL_CLI[cmd], "--device", device]
            flags = ["--dp", str(dp), "--tp", str(tp)]
            t = time.perf_counter()
            res = pm.launch(rl_cli_rank, dp * tp, (argv + flags + [
                "--exp-dir", d("mesh", "e"), "--ckpt-dir", d("mesh", "c")], dp * tp, device),
                backend="gloo", timeout_s=600)
            wall = time.perf_counter() - t
            os.environ.update(RL_ROUTES)
            try:
                one = cli.main(argv + ["--exp-dir", d("one", "e"), "--ckpt-dir", d("one", "c")])
                del one["final"]
            finally:
                for k, v in keep.items():
                    os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
            r0 = res[0]["res"]
            cfg = (C.agent_config(n_layer=4) if cmd == "dqn-train" else
                   C.actor_config(n_layer=4))
            names = ("dqn_best.ckpt", "dqn_last.ckpt") if cmd == "dqn-train" else ("ppo_best.ckpt",)
            shapes = {}
            for name in names:
                ck = load_checkpoint(d("mesh", "c", name),
                                     params_template=lt.init_params(cfg, device="cpu"),
                                     device="cpu")
                shapes[name] = tuple(ck["params"]["layers"]["ffn1"]["w"].shape)
            med = lambda v: sorted(v)[len(v) // 2] if v else float("nan")
            found[cmd] = {"res": r0, "one": one, "runs": [r["runs"] for r in res],
                          "wall_s": wall, "shapes": shapes,
                          "whole": (cfg.n_layer, cfg.d_model, cfg.d_inner)}
            print(f"[rl] 41: cli {cmd} {' '.join(flags)} over gloo on one card ({smi_line}): "
                  f"{wall:.1f}s with the ranks' start; ms per rollout song {r0['rollout_ms']} "
                  f"(median {med(r0['rollout_ms']):.1f}; one process {med(one['rollout_ms']):.1f},"
                  f" graphed), ms per update {r0['update_ms']} (one process {one['update_ms']}); "
                  f"metrics {r0['metrics']}; runs {RL_RUNS} a rank "
                  f"{found[cmd]['runs']}; checkpoints' ffn1 {shapes}; digests {r0['digests']}",
                  flush=True)
    return found


def rl_cli_gate_failures(found: dict) -> list:
    """Phase 41's gates: finite metrics, dqn-train's two updates, every
    rank's parameters (and dqn-train's generator) equal, whole checkpoints,
    kernel F run on every rank."""
    fails = []
    for cmd, f in found.items():
        r0 = f["res"]
        if not r0["metrics"] or not all(math.isfinite(v) for m_ in r0["metrics"]
                                        for v in m_.values()):
            fails.append(f"cli {cmd}: no metrics, or one not finite: {r0['metrics']}")
        if cmd == "dqn-train" and r0["updates"] != 2:
            fails.append(f"cli dqn-train: {r0['updates']} updates, expected 2")
        for k, v in r0["digests"].items():
            if len(set(v)) != 1:
                fails.append(f"cli {cmd}: the ranks' {k} digests differ")
        if any(s != f["whole"] for s in f["shapes"].values()):
            fails.append(f"cli {cmd}: a checkpoint is not the whole tree: {f['shapes']}")
        if any(r[0] == 0 for r in f["runs"]):
            fails.append(f"cli {cmd}: kernel F ran no time on a rank: {f['runs']}")
    return fails


def rl_run(cfg, smi_line, *, backend: str = "gloo", meshes=None, n_layer: int = 12,
           cli_meshes=None) -> dict:
    """Phases 39-41: the (dp, tp) meshes of ``rl_rank``, over gloo all on
    card 0 (39: dp = 1 x tp = 2, the DQN update, the discriminator step at
    100 x 50 and 4 x 2048, a DQN rollout song; 40: dp = 2 x tp = 2, the PPO
    rollout song and update step, the DQN update with control (i), the
    discriminator step and the split discriminator epoch; 40b: dp = 2 x tp =
    1 under RLMG_FFN_BACKEND=pallas too, the graphed DQN and PPO rollouts,
    the DQN update, the PPO step, and the split epoch on kernel D's route
    with its control), or over nccl a card each (scripts/dp_nccl.py --rl); then (41, gloo only) the two RL commands on a mesh through the
    CLI.  Prints the readings, fails on the gates, returns each phase's
    rank-0 readings and every rank's kernel runs."""
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    if meshes is None:
        meshes = [dict(phase=39, dp=1, tp=2, steps=("dqn", "disc", "disc_long", "rollout")),
                  dict(phase=40, dp=2, tp=2, steps=("ppo", "dqn", "control", "disc",
                                                    "disc_split")),
                  dict(phase="40b", dp=2, tp=1, ffn="pallas",
                       steps=("rollout", "dqn", "ppo", "disc_split"),
                       disc_route=DISC_SPLIT_D_ROUTE, disc_control=True)]
    cards = "all on card 0" if backend == "gloo" else "a card each"
    found = {}
    t_all = time.perf_counter()
    for spec in meshes:
        spec = dict(spec, backend=backend, n_layer=n_layer)
        world = spec["dp"] * spec["tp"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()        # the ranks are processes of their own
        t = time.perf_counter()
        res = pm.launch(rl_rank, world, (spec,), backend=backend, timeout_s=900)
        wall = time.perf_counter() - t
        r0 = res[0]["steps"]
        tag = (f"[rl] {spec['phase']}: dp={spec['dp']} x tp={spec['tp']} over {backend}, {cards}"
               + (f", RLMG_FFN_BACKEND={spec['ffn']}" if spec.get("ffn") else ""))
        print(f"{tag} ({smi_line}): {wall:.1f}s with the ranks' start", flush=True)
        for name, s in r0.items():
            e = s.get("errors")
            errs = "" if e is None else "; against one process: " + (
                "; ".join(f"{t_} loss {e_['loss']:.2e}, gradients {e_['grads'][0]:.3e} "
                          f"({e_['grads'][1]}), params {e_['params'][0]:.3e}, updates "
                          f"{e_['updates'][0]:.3e} ({e_['updates'][1]})"
                          for t_, e_ in zip(("actor", "critic"), e))
                if isinstance(e, tuple) else
                f"loss {e['loss']:.2e}, gradients {e['grads'][0]:.3e} ({e['grads'][1]}), "
                f"params {e['params'][0]:.3e}, updates {e['updates'][0]:.3e} "
                f"({e['updates'][1]})")
            print(f"{tag} {name}: runs {RL_RUNS} a rank "
                  f"{[r['steps'][name]['runs'] for r in res]}; ms on the ranks "
                  f"{[round(r['steps'][name]['ms'], 1) for r in res]}, one process "
                  f"{s.get('ms_single', float('nan')):.1f}"
                  + (f"; loss {s['loss']} one process {s.get('loss_single')}" if "loss" in s
                     else "") + errs
                  + (f"; zero-gradient leaves' largest |g| {s['noise']:.3e} (one process "
                     f"{s.get('noise_single', float('nan')):.3e})" if "noise" in s else "")
                  + (f"; actions equal {s['actions_equal']}, first apart {s['apart']}"
                     if "actions_equal" in s else "")
                  + (f"; rows a rank {s['rows']}" if "rows" in s else "")
                  + (f"; leaves not bit-equal when one process repeats the step "
                     f"{s['repeat_differs']}" if "repeat_differs" in s else "")
                  + (f"; control (each rank's own BatchNorm statistics): loss "
                     f"{s['control_errors']['loss']:.2e}, gradients "
                     f"{s['control_errors']['grads'][0]:.3e} ({s['control_errors']['grads'][1]})"
                     if "control_errors" in s else "")
                  + ("; parameters bit-equal on the ranks" if "digests" in s and len(
                      set(s["digests"])) == 1 else ""), flush=True)
        fails = rl_gate_failures(res, spec)
        check(not fails, f"rl over {backend}, phase {spec['phase']}: " + "; ".join(fails))
        found[spec["phase"]] = {"steps": r0, "runs": {name: [r["steps"][name]["runs"]
                                                             for r in res] for name in r0}}
    if backend == "gloo":
        cli_found = rl_cli_run(smi_line, cli_meshes or {"dqn-train": (1, 2),
                                                        "ppo-train": (2, 2)})
        fails = rl_cli_gate_failures(cli_found)
        check(not fails, "rl, phase 41: " + "; ".join(fails))
        found[41] = {"runs": {cmd: f["runs"] for cmd, f in cli_found.items()}}
    print(f"[time] phases 39-41: {time.perf_counter() - t_all:.1f}s ({smi_line})", flush=True)
    return found


# -- sequence and pipeline parallelism: phases 42-44 ---------------------------
# kernel F in each sp rank's call; kernel D in each pipeline stage
SP_SHAPE = (32, 8, 512, 64)      # the pretrain shape (B, H, S, E)
PP_ROUTE = {"RLMG_FFN_BACKEND": "pallas-tail", "RLMG_ATTN_BACKEND": "xla"}
# phase 11's gates of kernel F against its twin: out within 1e-4 of its
# magnitude, the gradients within 1e-3 of theirs
SP_GATES = {"out": 1e-4, "dq": 1e-3, "dk": 1e-3, "dv": 1e-3}


def _rank_mesh(spec: dict, shape: dict):
    """The named mesh of ``shape`` for a rank of ``spec``: over nccl rank r
    on card r, else over gloo every rank on ``spec["device"]`` (card 0; "cpu"
    rehearses on the kernels' plain versions)."""
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    if spec.get("backend", "gloo") == "nccl":
        return pm.named_mesh(shape)
    dev = torch.device(spec.get("device", "cuda:0"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return pm.named_mesh(shape, devices=[dev] * math.prod(shape.values()), backend="gloo")


def sp_errors(out, grads, ref_out, ref_grads) -> dict:
    """max|diff| over the reference's magnitude, for out and dq, dk, dv."""
    errs = {"out": max_err(out, ref_out) / magnitude(ref_out)}
    errs.update({k: max_err(a, b) / magnitude(b)
                 for k, a, b in zip(("dq", "dk", "dv"), grads, ref_grads)})
    return errs


def sp_rank(spec: dict) -> dict:
    """Phase 42 on one rank of an sp mesh of ``spec["sp"]`` ranks: q, k, v
    and the output's cotangent g at ``spec["shape"]`` (the whole sequence,
    from one seed on every rank), the rank's shard of the sequence through
    ``causal_linear_attention_sp(backend="pallas")`` forward and backward
    (kernel F on (B, H, S / sp, E)): F's wrapper counts and its own runs
    read around that call alone; the shards gathered, and on rank 0 the
    one-process ``causal_linear_attention(backend="pallas")`` on the whole
    sequence, the errors against it (``sp_errors``) and the two controls'
    (an inclusive prefix; a gather whose backward keeps the rank's own
    cotangent); then ms of the rank's call and of one process's."""
    import torch.distributed as dist
    from reinforcement_learning_in_music_generation_torch.ops import (
        linear_attention as tla, linear_attention_kernel as tlk)
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    from reinforcement_learning_in_music_generation_torch.parallel import tensor as ptn
    n = spec["sp"]
    mesh = _rank_mesh(spec, {"sp": n})
    dev = mesh.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    b, h, s, e = spec["shape"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v, g = (torch.randn((b, h, s, e), generator=gen, device=dev) for _ in range(4))
    i, w = mesh.index("sp"), s // n
    mine = [t[:, :, i * w:(i + 1) * w].contiguous() for t in (q, k, v, g)]

    def call(qq, kk, vv, gg, fn=None):
        leaves = [t.detach().clone().requires_grad_(True) for t in (qq, kk, vv)]
        out = (fn or (lambda *a: tla.causal_linear_attention_sp(*a, mesh, "sp",
                                                                backend="pallas")))(*leaves)
        out.backward(gg)
        return out.detach(), [t.grad for t in leaves]

    def whole(out, grads):
        return [torch.cat(pm.all_gather(mesh, t, axis="sp"), dim=2) for t in [out] + grads]

    f = tlk.causal_product
    f.launches_fwd = f.launches_bwd = 0
    if cuda:
        tlk.kernel_runs(reset=True)
    res = call(*mine)
    sync()
    out = {"rank": mesh.rank, "index": i, "backend": mesh.backend,
           "counts": [f.launches_fwd, f.launches_bwd],
           "runs": list(tlk.kernel_runs()) if cuda else [0, 0]}
    got = whole(*res)
    controls = {}
    keep = tla.prefix_weights
    tla.prefix_weights = lambda n_, idx, dtype, device: (
        torch.arange(n_, device=device) <= idx).to(dtype)
    try:
        controls["inclusive_prefix"] = whole(*call(*mine))
    finally:
        tla.prefix_weights = keep

    class OwnSlot(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, mesh_, axis):
            ctx.i = mesh_.index(axis)
            return torch.stack(pm.all_gather(mesh_, x, axis=axis))

        @staticmethod
        def backward(ctx, gg):
            return gg[ctx.i], None, None
    keep = ptn.gather_over
    ptn.gather_over = lambda x, mesh_, axis: OwnSlot.apply(x, mesh_, axis)
    try:
        controls["no_reduce_scatter"] = whole(*call(*mine))
    finally:
        ptn.gather_over = keep
    if mesh.rank == 0:
        ref_out, ref_grads = call(q, k, v, g, lambda *a: tla.causal_linear_attention(
            *a, backend="pallas"))
        out["errors"] = sp_errors(got[0], got[1:], ref_out, ref_grads)
        out["controls"] = {c: sp_errors(t[0], t[1:], ref_out, ref_grads)
                           for c, t in controls.items()}
    del got, controls
    dist.barrier()
    out["ms"] = time_ms(lambda: call(*mine), spec.get("reps", 5)) if cuda else None
    dist.barrier()
    if mesh.rank == 0 and cuda:
        out["ms_single"] = time_ms(lambda: call(q, k, v, g, lambda *a: (
            tla.causal_linear_attention(*a, backend="pallas"))), spec.get("reps", 5))
    dist.barrier()
    return out


def sp_gate_failures(res: list, spec: dict) -> list:
    """Phase 42's gates: F's wrapper called once forward and once backward
    and run as often on every rank, the sp result within ``SP_GATES`` of one
    process's, each control outside them."""
    fails = []
    for r in res:
        if r["counts"] != [1, 1] or (spec.get("device", "cuda:0") != "cpu"
                                     and r["runs"] != [1, 1]):
            fails.append(f"rank {r['rank']}: F's calls {r['counts']}, its runs {r['runs']}, "
                         "expected [1, 1] each")
    e = res[0]["errors"]
    bad = {k: v for k, v in e.items() if not v <= SP_GATES[k]}
    if bad:
        fails.append(f"sp against one process: {bad} above {SP_GATES}")
    for name, c in res[0]["controls"].items():
        if all(v <= SP_GATES[k] for k, v in c.items()):
            fails.append(f"the control {name} passes the sp gates: {c}")
    return fails


def sp_run(smi_line, *, backend: str = "gloo", n: int = 2, shape=SP_SHAPE) -> dict:
    """Phase 42: ``sp_rank`` on ``n`` ranks (gloo all on card 0, or nccl a
    card each); prints the readings, fails on ``sp_gate_failures``."""
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    spec = {"sp": n, "shape": shape, "backend": backend}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    res = pm.launch(sp_rank, n, (spec,), backend=backend, timeout_s=600)
    wall = time.perf_counter() - t
    r0 = res[0]
    print(f"[sp] 42: causal_linear_attention_sp(backend='pallas') on sp = {n} over {backend} "
          f"({smi_line}): {wall:.1f}s with the ranks' start; q, k, v {shape}, a rank's shard "
          f"{shape[:2] + (shape[2] // n,) + shape[3:]}; F's calls (fwd, bwd) a rank "
          f"{[r['counts'] for r in res]}, its runs {[r['runs'] for r in res]}; against one "
          f"process's kernel-F call on the whole sequence (max|diff| / magnitude): "
          f"{ {k: f'{v:.3e}' for k, v in r0['errors'].items()} }; controls "
          + "; ".join(f"{c}: { {k: f'{v:.3e}' for k, v in e.items()} }"
                      for c, e in r0["controls"].items())
          + f"; ms a call fwd + bwd on the ranks {[r['ms'] for r in res]}, one process on the "
          f"whole sequence {r0.get('ms_single')}", flush=True)
    fails = sp_gate_failures(res, spec)
    check(not fails, f"sp over {backend}, phase 42: " + "; ".join(fails))
    return {"res": res, "wall_s": wall}


def pp_rank(spec: dict) -> dict:
    """Phase 43 on one rank of a (dp, pp) mesh of ``spec["dp"]`` x
    ``spec["pp"]`` ranks under ``PP_ROUTE`` (kernel D in every stage): the
    config's keywords ("cfg"), the global batch "B" x "S" (the second half's
    rows masked after "valid_tail" positions).  One f32 pipeline step
    (dropout 0, m = 2 pp microbatches, the grad step, the clip by the
    mesh's norm, Adam) with the kernels' wrapper counts read around it, the
    whole trees gathered; a digest of the rank's replicated leaves after
    it; rank 0 also takes one process's ``agent_train_step`` on the whole
    batch on the same route and holds the step against it
    (``step_errors``), and, with "control", the step whose heads' and
    final_ln's gradients are counted pp times.  "g_route": the same step
    and its check under RLMG_FFN_BACKEND=pallas (kernel G in every stage).
    "dropout": dtypes of one step each at dropout 0.1 (the losses);
    "times": ms a pipeline step and one process's."""
    import dataclasses
    import hashlib
    import torch.distributed as dist
    from reinforcement_learning_in_music_generation_torch import config as C
    from reinforcement_learning_in_music_generation_torch.data import dataset
    from reinforcement_learning_in_music_generation_torch.models import linear_transformer as lt
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    from reinforcement_learning_in_music_generation_torch.parallel import pipeline as ppl
    from reinforcement_learning_in_music_generation_torch.parallel import sharding as psh
    from reinforcement_learning_in_music_generation_torch.train import (
        optim as topt, pretrain as tpre)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k_ in ("RLMG_FFN_BACKEND", "RLMG_ATTN_BACKEND", "RLMG_WINDOW_BACKEND", "RLMG_FFN_MIN_ROWS"):
        os.environ.pop(k_, None)
    os.environ.update(PP_ROUTE)
    dp, pp = spec["dp"], spec["pp"]
    mesh = _rank_mesh(spec, {"dp": dp, "pp": pp, "tp": 1})
    dev = mesh.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rank = mesh.rank
    out = {"rank": rank, "index": (mesh.dp_index, mesh.pp_index), "backend": mesh.backend}
    counters = train_counters()
    cfg = C.LinearTransformerConfig(**spec["cfg"], dropout=0.0)
    p0 = lt.init_params(cfg, seed=0, device=dev)
    mine_p = ppl.shard_params_pp(mesh, topt.tree_map(torch.clone, p0))
    b, s_len, tail = spec["B"], spec["S"], spec["valid_tail"]
    x, y, m = dataset.synthetic_cp_dataset(b, s_len, n_class=cfg.vocab_sizes, seed=0)
    m = np.ones_like(m, dtype=np.float32)
    m[b // 2:, tail:] = 0.0
    full = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (x.astype(np.int64), y.astype(np.int64), m))
    tx = topt.adam(1e-4, grad_clip=3.0)
    m_mb = ppl.n_microbatches(cfg, mesh, b)
    out["microbatches"] = m_mb
    out["rows_a_microbatch"] = b // (dp * m_mb) * s_len

    def digest(tree) -> str:
        h_ = hashlib.sha256()
        for path, t in sorted(named_leaves(tree).items()):
            if not path.startswith("/layers"):
                h_.update(t.detach().float().cpu().numpy().tobytes())
        return h_.hexdigest()[:16]

    def readings(loss, losses, prm, grads, updates):
        return [float(loss), losses.cpu(), named_leaves(prm), named_leaves(grads),
                named_leaves(updates)]

    def route_step(route: dict, control: bool) -> dict:
        """The main path's step on ``route`` (the counts set to 0 just before
        it, read after it), the ranks' losses and replicated digests; on
        rank 0 the errors against one process's step on the same route
        (and the control's, with ``control``)."""
        os.environ.update(route)
        res = {}
        prm = topt.tree_map(torch.clone, mine_p)
        st = tx.init(prm)
        for fn, attr in counters:
            setattr(fn, attr, 0)
        grads, (loss, losses) = tpre.agent_pp_grad_step(prm, cfg, *full, None, mesh=mesh)
        updates, _ = tx.update(grads, st, prm, mesh=mesh)
        prm = topt.apply_updates(prm, updates)
        sync()
        res["counts"] = [getattr(fn, attr) for fn, attr in counters]
        pp_out = readings(loss, losses, psh.gather_params(mesh, prm),
                          psh.gather_params(mesh, grads), psh.gather_params(mesh, updates))
        ctl = None
        if control:
            # every stage's heads run, their gradients summed over pp
            twice = topt.tree_map(torch.clone, grads)
            for key in ("heads", "final_ln"):
                twice[key] = topt.tree_map(lambda t: t * pp, twice[key])
            prm_c = topt.tree_map(torch.clone, mine_p)
            upd_c, _ = tx.update(twice, tx.init(prm_c), prm_c, mesh=mesh)
            prm_c = topt.apply_updates(prm_c, upd_c)
            ctl = readings(loss, losses, psh.gather_params(mesh, prm_c),
                           psh.gather_params(mesh, twice), psh.gather_params(mesh, upd_c))
            del prm_c, upd_c, twice
        res["loss_ranks"] = pm.all_gather_object(mesh, float(loss), axis="world")
        res["digests"] = pm.all_gather_object(mesh, digest(prm), axis="world")
        del grads, updates, prm
        dist.barrier()
        if rank == 0:
            prm = topt.tree_map(torch.clone, p0)
            st = tx.init(prm)
            grads, (loss1, losses1) = tpre.agent_grad_step(prm, cfg, *full, None)
            updates, _ = tx.update(grads, st, prm)
            prm = topt.apply_updates(prm, updates)
            ref = readings(loss1, losses1, prm, grads, updates)
            res["loss_single"] = float(loss1)
            res["errors"] = step_errors(pp_out, ref)
            if ctl is not None:
                res["control_errors"] = step_errors(ctl, ref)
            del prm, grads, updates, ref
        del pp_out, ctl
        dist.barrier()
        return res

    out.update(route_step(PP_ROUTE, bool(spec.get("control"))))
    if spec.get("g_route"):
        out["g"] = route_step({"RLMG_FFN_BACKEND": "pallas"}, False)
    os.environ.update(PP_ROUTE)
    out["dropout"] = {}
    for dt in spec.get("dropout", ()):
        dcfg = dataclasses.replace(cfg, dropout=0.1, dtype=dt)
        gen = torch.Generator(device=dev)
        gen.manual_seed(7 + 7919 * (mesh.dp_index * pp + mesh.pp_index))
        prm = topt.tree_map(torch.clone, mine_p)
        prm, _, (ld, _) = tpre.agent_pp_train_step(prm, tx.init(prm), dcfg, tx, *full, gen,
                                                   mesh=mesh)
        out["dropout"][dt] = pm.all_gather_object(mesh, float(ld), axis="world")
        del prm
    if spec.get("times") and cuda:
        def timed(step_fn, prm0, n=2):
            prm_ = topt.tree_map(torch.clone, prm0)
            st_ = tx.init(prm_)
            prm_, st_, _ = step_fn(prm_, st_)
            sync()
            t = time.perf_counter()
            for _ in range(n):
                prm_, st_, _ = step_fn(prm_, st_)
            sync()
            return (time.perf_counter() - t) / n * 1e3
        dist.barrier()
        out["ms"] = timed(lambda p_, s_: tpre.agent_pp_train_step(p_, s_, cfg, tx, *full, None,
                                                                  mesh=mesh), mine_p)
        dist.barrier()
        if rank == 0:
            out["ms_single"] = timed(lambda p_, s_: tpre.agent_train_step(p_, s_, cfg, tx, *full,
                                                                          None), p0)
        dist.barrier()
    return out


def pp_gate_failures(res: list, spec: dict) -> list:
    """Phase 43's gates over every rank's ``pp_rank`` readings: kernel D's
    wrapper launched (n_layer / pp) x m times forward and backward on every
    stage and no other kernel; the losses equal and finite on every rank;
    the replicated leaves bit-equal on every rank after the step; the step
    within ``STEP_GATES`` of one process's; the control outside them; the
    dropout steps' losses finite and equal on every rank."""
    fails = []
    r0 = res[0]
    n = spec["n_layer"] // spec["pp"] * r0["microbatches"]
    for name, want, get in (("D", [0, 0, n, n] + [0] * 6, lambda r: r),
                            ("G", [0] * 8 + [n, n], lambda r: r.get("g"))):
        if get(r0) is None:
            continue
        for r in res:
            if get(r)["counts"] != want:
                fails.append(f"rank {r['rank']}, {name} route: launches (C, D, E, F, G "
                             f"fwd/bwd) {get(r)['counts']}, expected {want}")
        s0 = get(r0)
        if len(set(s0["loss_ranks"])) != 1 or not all(math.isfinite(v)
                                                       for v in s0["loss_ranks"]):
            fails.append(f"{name} route: losses on the ranks {s0['loss_ranks']}")
        if len(set(s0["digests"])) != 1:
            fails.append(f"{name} route: the replicated leaves differ between the ranks: "
                         f"{s0['digests']}")
        bad = step_gate_failures(s0["errors"])
        if bad:
            fails.append(f"{name} route: pipeline step against one process: {bad}")
    if "control_errors" in r0 and not step_gate_failures(r0["control_errors"]):
        fails.append("the control (the heads' gradients counted pp times) passes the step gate")
    for dt, losses in r0["dropout"].items():
        if len(set(losses)) != 1 or not all(math.isfinite(v) for v in losses):
            fails.append(f"dropout 0.1, {dt}: losses on the ranks {losses}")
    return fails


def pp_rank_cli(argv: list, world: int, device=None) -> dict:
    """One rank of ``cli pretrain --pp`` on a mesh of ``world`` ranks: over
    gloo every rank on ``device`` (phase 44), or with ``device`` None over
    the process group's NCCL, rank r on card r (scripts/dp_nccl.py --pp);
    the command runs on the rank's mesh as ``apps/cli.py``'s rank entry runs
    it (rank 0 alone prints)."""
    import contextlib
    from reinforcement_learning_in_music_generation_torch.apps import cli
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    args = cli.build_parser().parse_args(argv)
    shape = {"dp": args.dp, "pp": args.pp, "tp": args.tp}
    if device is None:
        mesh = pm.named_mesh(shape)
    else:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = pm.named_mesh(shape, devices=[dev] * world, backend="gloo")
    with open(os.devnull, "w") as null, \
            contextlib.redirect_stdout(sys.stdout if mesh.rank == 0 else null):
        return args.fn(args, mesh=mesh)


PP_CLI = ["pretrain", "--synthetic", "--synthetic-songs", "8", "--batch-size", "8",
          "--seq-len", "512", "--layers", "4"]


def pp_cli_run(smi_line, *, dp: int = 2, pp: int = 2, device="cuda:0", backend="gloo") -> dict:
    """Phase 44: ``cli pretrain --pp {pp} --dp {dp}`` (``PP_CLI``: 4 layers,
    one 8 x 512 batch an epoch, one epoch) on gloo ranks sharing ``device``
    (or NCCL a card a rank), then ``cli pretrain`` in this process at pp 1
    resuming from its checkpoint for a second epoch; the checkpoint loaded
    whole."""
    from reinforcement_learning_in_music_generation_torch import config as C
    from reinforcement_learning_in_music_generation_torch.apps import cli
    from reinforcement_learning_in_music_generation_torch.models import linear_transformer as lt
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    from reinforcement_learning_in_music_generation_torch.utils.checkpoint import load_checkpoint
    world = dp * pp
    with tempfile.TemporaryDirectory() as tmp:
        d = lambda *p: os.path.join(tmp, *p)
        flags = ["--pp", str(pp), "--dp", str(dp)]
        t = time.perf_counter()
        res = pm.launch(pp_rank_cli, world, (PP_CLI + flags + [
            "--device", device or "cuda", "--epochs", "1", "--exp-dir", d("e"),
            "--ckpt-dir", d("c")], world, device), backend=backend, timeout_s=600)
        wall = time.perf_counter() - t
        names = sorted(os.listdir(d("c")))
        ck = load_checkpoint(d("c", names[0]), params_template=lt.init_params(
            C.agent_config(n_layer=4), device="cpu"), device="cpu") if names else None
        shape = None if ck is None else tuple(ck["params"]["layers"]["ffn1"]["w"].shape)
        resumed = cli.main(PP_CLI + ["--device", device or "cuda", "--epochs", "2", "--resume",
                                     d("c", names[0]), "--exp-dir", d("e1"),
                                     "--ckpt-dir", d("c1")]) if names else None
    r0 = res[0]
    found = {"res": r0, "wall_s": wall, "ckpt": names, "shape": shape, "resumed": resumed}
    print(f"[pp] 44: cli pretrain {' '.join(flags)} over {backend} ({smi_line}): {wall:.1f}s with "
          f"the ranks' start; {r0['steps']} step(s), batch losses {r0['batch_losses']}, history "
          f"{r0['history']}, {r0['tokens_per_s']:.1f} tokens/s; checkpoints {names}, ffn1 "
          f"{shape}; resumed at pp 1: history {resumed and resumed['history']}, steps "
          f"{resumed and resumed['steps']}", flush=True)
    fails = []
    if not (r0["steps"] == 1 and r0["history"] and all(math.isfinite(v) for v in
                                                       r0["history"] + r0["batch_losses"])):
        fails.append(f"the pp run: {r0['steps']} steps, history {r0['history']}")
    if shape != (4, 512, 2048):
        fails.append(f"the checkpoint is not the whole tree: ffn1 {shape} ({names})")
    if not (resumed and resumed["steps"] == 1 and len(resumed["history"]) == 1
            and math.isfinite(resumed["history"][0])):
        fails.append(f"the resume at pp 1: {resumed}")
    check(not fails, "pp, phase 44: " + "; ".join(fails))
    return found


def pp_run(cfg, smi_line, *, backend: str = "gloo", meshes=None, cli: bool = True) -> dict:
    """Phases 43-44: ``pp_rank`` on (dp, pp) meshes at ``cfg``'s width under
    ``PP_ROUTE``, over gloo all on card 0 (43: pp = 2 with the control and
    the dropout steps at f32 and bf16, then dp = 2 x pp = 2, each B = 32 x
    512) or over nccl a card each (scripts/dp_nccl.py --pp); then (44)
    ``pp_cli_run``.  Prints the readings, fails on the gates, returns each
    mesh's readings."""
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    # the step's times over NCCL only (ranks sharing one card over gloo share
    # its SMs: their times say nothing of scaling)
    base = {"cfg": dict(vocab_sizes=cfg.vocab_sizes), "n_layer": cfg.n_layer, "B": 32,
            "S": 512, "valid_tail": 100, "times": backend == "nccl"}
    if meshes is None:
        meshes = [dict(base, phase=43, dp=1, pp=2, control=True, g_route=True,
                       dropout=("float32", "bfloat16")),
                  dict(base, phase="43b", dp=2, pp=2)]
    found = {}
    t_all = time.perf_counter()
    for spec in meshes:
        spec = dict(base, **spec, backend=backend)
        world = spec["dp"] * spec["pp"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        res = pm.launch(pp_rank, world, (spec,), backend=backend, timeout_s=900)
        wall = time.perf_counter() - t
        r0 = res[0]
        e = r0["errors"]
        tag = f"[pp] {spec['phase']}: dp={spec['dp']} x pp={spec['pp']} over {backend}"
        print(f"{tag} ({smi_line}): {wall:.1f}s with the ranks' start; {r0['microbatches']} "
              f"microbatches of {r0['rows_a_microbatch']} rows; launches (C, D, E, F, G "
              f"fwd/bwd) a rank {[r['counts'] for r in res]}; loss {r0['loss_ranks']} one "
              f"process {r0['loss_single']:.7f}; against one process: loss {e['loss']:.2e}, "
              f"gradients {e['grads'][0]:.3e} ({e['grads'][1]}), params {e['params'][0]:.3e}, "
              f"updates {e['updates'][0]:.3e} ({e['updates'][1]}); replicated leaves' digests "
              f"{r0['digests']}"
              + (f"; control (heads counted pp times): gradients "
                 f"{r0['control_errors']['grads'][0]:.3e} ({r0['control_errors']['grads'][1]})"
                 if "control_errors" in r0 else "")
              + (f"; dropout 0.1 losses {r0['dropout']}" if r0["dropout"] else "")
              + (f"; under RLMG_FFN_BACKEND=pallas (kernel G): launches a rank "
                 f"{[r['g']['counts'] for r in res]}, against one process: loss "
                 f"{r0['g']['errors']['loss']:.2e}, gradients {r0['g']['errors']['grads'][0]:.3e}"
                 f" ({r0['g']['errors']['grads'][1]}), params "
                 f"{r0['g']['errors']['params'][0]:.3e}, updates "
                 f"{r0['g']['errors']['updates'][0]:.3e}" if "g" in r0 else "")
              + f"; ms a step {[round(r.get('ms') or float('nan'), 1) for r in res]}, one "
              f"process {r0.get('ms_single', float('nan')):.1f}"
              + ("; ranks sharing one card share its SMs, so these times say nothing of "
                 "scaling" if backend == "gloo" else ""), flush=True)
        fails = pp_gate_failures(res, spec)
        check(not fails, f"pp over {backend}, phase {spec['phase']}: " + "; ".join(fails))
        found[spec["phase"]] = {"res": res, "wall_s": wall}
    if cli:
        found[44] = pp_cli_run(smi_line, device="cuda:0" if backend == "gloo" else None,
                               backend=backend)
    print(f"[time] phases 43-44: {time.perf_counter() - t_all:.1f}s ({smi_line})", flush=True)
    return found


# -- the sharded checkpoint: phase 45 -------------------------------------------
# cli pretrain on a dp = 2 x tp = 2 mesh with ZeRO-1, kernel F on each rank's
# heads (the agent's layers under tp take the composition, F its product)
CKPT_CLI = ["pretrain", "--synthetic", "--synthetic-songs", "8", "--batch-size", "8",
            "--seq-len", "512", "--layers", "4"]
CKPT_ROUTE = {"RLMG_ATTN_BACKEND": "pallas"}


def ckpt_rank_cli(argv: list, world: int, device=None) -> dict:
    """One rank of ``cli pretrain --dp --tp`` under ``CKPT_ROUTE``: over
    gloo every rank on ``device`` (phase 45), or with ``device`` None over
    the process group's NCCL, rank r on card r (scripts/dp_nccl.py --ckpt);
    the command's numbers with this rank's (F fwd, F bwd) wrapper launches
    and the seconds of each checkpoint: the directory's save to return and
    to commit on this rank, or the pickle's gather (every rank, from the
    save's start to rank 0's write) and rank 0's write."""
    import contextlib
    from reinforcement_learning_in_music_generation_torch.apps import cli
    from reinforcement_learning_in_music_generation_torch.ops import linear_attention_kernel as tlk
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre
    os.environ.update(CKPT_ROUTE)
    args = cli.build_parser().parse_args(argv)
    # the CLI's rank mesh: (dp, pp, tp) with --pp > 1, else (dp, tp)
    shape = ({"dp": args.dp, "pp": args.pp, "tp": args.tp} if args.pp > 1
             else {"dp": args.dp, "tp": args.tp})
    if device is None:
        mesh = pm.named_mesh(shape)
    else:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = pm.named_mesh(shape, devices=[dev] * world, backend="gloo")
    f = tlk.causal_product
    f.launches_fwd = f.launches_bwd = 0
    names = ("save_checkpoint_orbax", "wait_for_checkpoints", "full_opt_state",
             "save_checkpoint")
    orig = {n: getattr(tpre, n) for n in names}
    times = []

    def save_orbax(*a, **kw):
        t = time.perf_counter()
        out = orig["save_checkpoint_orbax"](*a, **kw)
        times.append({"return_s": time.perf_counter() - t, "t_save": t})
        return out

    def wait():
        orig["wait_for_checkpoints"]()
        if times and "t_save" in times[-1]:
            times[-1]["wait_s"] = time.perf_counter() - times[-1].pop("t_save")

    def full_state(*a, **kw):                # the pickle's save starts with the gathers
        times.append({"t_gather": time.perf_counter()})
        return orig["full_opt_state"](*a, **kw)

    def write(*a, **kw):                     # rank 0's pickle write
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t = time.perf_counter()
        times[-1]["gather_s"] = t - times[-1].pop("t_gather")
        out = orig["save_checkpoint"](*a, **kw)
        times[-1]["write_s"] = time.perf_counter() - t
        return out
    for n, fn in zip(names, (save_orbax, wait, full_state, write)):
        setattr(tpre, n, fn)
    try:
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(sys.stdout if mesh.rank == 0 else null):
            res = args.fn(args, mesh=mesh)
    finally:
        for n, fn in orig.items():
            setattr(tpre, n, fn)
    times = [{k: v for k, v in t_.items() if not k.startswith("t_")} for t_ in times]
    return {**res, "rank": mesh.rank, "f_launches": [f.launches_fwd, f.launches_bwd],
            "saves": times}


class LiveSnapshot:
    """Phase 45's control: a save that keeps the live tensors and reads them
    only when its writer writes (the fault the snapshot guards against)."""

    def __init__(self, pieces):
        self.pieces = pieces

    def numpy(self):
        return torch.cat(self.pieces).cpu().numpy()


def ckpt_files(path: str) -> dict:
    """The directory's index read: its writers and, per writing rank, its
    data file's bytes and shard count."""
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    per = {}
    for sh in index["shards"]:
        r = per.setdefault(sh["rank"], {"file": sh["file"], "bytes": 0, "shards": 0})
        r["bytes"] += sh["nbytes"]
        r["shards"] += 1
    for r, v in per.items():
        v["on_disk"] = os.path.getsize(os.path.join(path, v["file"]))
    return {"mesh": index["mesh"], "writers": index["writers"], "per_rank": per,
            "files": sorted(os.listdir(path))}


def ckpt_run(cfg, smi_line, dev, device="cuda:0", backend="gloo") -> dict:
    """Phase 45 (item 9(e)).  In this process at ``cfg``'s width: one
    ``agent_train_step`` at B = 32 x S = 512 (kernels C and D), then the
    pickle ``save_checkpoint`` (wall), ``save_checkpoint_orbax`` (to return,
    then to ``wait_for_checkpoints``), both read back bit-equal; the
    in-place control (the parameters and moments updated right after the
    save returns; the read must be the tree before, and a saver that keeps
    the live tensors, held until the update, must fail that check).  Then
    ``cli pretrain --dp 2 --tp 2 --zero1 --ckpt-backend orbax`` (``CKPT_CLI``)
    on gloo ranks sharing ``device`` (or NCCL a card a rank), F on each
    rank's heads; its directory's files per rank; and ``cli pretrain`` in
    this process at pp 1 resuming from that directory for a second
    epoch."""
    import threading
    from reinforcement_learning_in_music_generation_torch import config as C
    from reinforcement_learning_in_music_generation_torch.apps import cli
    from reinforcement_learning_in_music_generation_torch.data import dataset
    from reinforcement_learning_in_music_generation_torch.models import linear_transformer as lt
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    from reinforcement_learning_in_music_generation_torch.train import optim as topt
    from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre
    from reinforcement_learning_in_music_generation_torch.utils import checkpoint as tck
    t_all = time.perf_counter()
    found, fails = {}, []
    counters = train_counters()
    for fn, attr in counters:
        setattr(fn, attr, 0)
    prm = lt.init_params(cfg, seed=0, device=dev)
    tx = topt.adam(1e-4, grad_clip=3.0)
    state = tx.init(prm)
    x, y, m = (torch.from_numpy(a).to(dev) for a in
               dataset.synthetic_cp_dataset(32, 512, n_class=cfg.vocab_sizes, seed=0))
    prm, state, (loss, _) = tpre.agent_train_step(prm, state, cfg, tx, x.long(), y.long(), m,
                                                  None)
    torch.cuda.synchronize()
    found["step_counts"] = [getattr(fn, attr) for fn, attr in counters][:4]
    if found["step_counts"] != [cfg.n_layer] * 4:
        fails.append(f"the step's (C, D fwd/bwd) launches {found['step_counts']}")
    n_bytes = sum(t.numel() * t.element_size() for t in topt.tree_leaves(prm)) * 3

    def same(a, b) -> bool:
        return all(torch.equal(u.to(v.device, v.dtype), v) for u, v in
                   zip(topt.tree_leaves(a), topt.tree_leaves(b)))

    with tempfile.TemporaryDirectory() as tmp:
        d = lambda *p: os.path.join(tmp, *p)
        t = time.perf_counter()
        tck.save_checkpoint(d("a.ckpt"), prm, state, step=1, extra={"epoch": 0})
        pickle_s = time.perf_counter() - t
        t = time.perf_counter()
        tck.save_checkpoint_orbax(d("a_dir.ckpt"), prm, state, step=1, extra={"epoch": 0})
        return_s = time.perf_counter() - t
        tck.wait_for_checkpoints()
        wait_s = time.perf_counter() - t
        a = tck.load_checkpoint(d("a.ckpt"), device=dev)
        b = tck.load_checkpoint_orbax(d("a_dir.ckpt"), device=dev)
        equal = (same(b["params"], a["params"]) and same(b["opt_state"].mu, a["opt_state"].mu)
                 and same(b["opt_state"].nu, a["opt_state"].nu)
                 and b["opt_state"].count == a["opt_state"].count == 1
                 and same(b["params"], prm))
        del a, b
        if not equal:
            fails.append("the directory and the pickle read back differently")
        # the in-place control: updates right after the save returns; the
        # held writer makes the live saver's fault certain to show
        before = topt.tree_map(torch.clone, prm)
        reads = {}
        for name, snap in (("snapshot", tck._snapshot), ("live", LiveSnapshot)):
            go = threading.Event()
            writer, keep_snap = tck._writer, tck._snapshot
            tck._writer = lambda *a_, w=writer: (go.wait(60), w(*a_))
            tck._snapshot = snap
            try:
                tck.save_checkpoint_orbax(d(f"{name}.ckpt"), prm, state)
                topt.tree_map(lambda t_: t_.add_(1.0), prm)
                torch.cuda.synchronize()
                go.set()
                tck.wait_for_checkpoints()
            finally:
                tck._writer, tck._snapshot = writer, keep_snap
            reads[name] = same(tck.load_checkpoint_orbax(d(f"{name}.ckpt"),
                                                         device=dev)["params"], before)
            topt.tree_map(lambda t_, b_: t_.copy_(b_), prm, before)
        if reads != {"snapshot": True, "live": False}:
            fails.append(f"the in-place control: the read equals the tree before the update "
                         f"{reads} (expected the snapshot's True, the live saver's False)")
        found.update(loss=float(loss), pickle_s=pickle_s, return_s=return_s, wait_s=wait_s,
                     bytes=n_bytes, equal=equal, in_place=reads)
        print(f"[ckpt] 45: agent_config ({lt.n_params(prm):,d} parameters, {n_bytes / 1e6:.1f} "
              f"MB with Adam's moments) after one step (loss {float(loss):.6f}, launches (C, D "
              f"fwd/bwd) {found['step_counts']}): pickle save_checkpoint {pickle_s:.3f} s; "
              f"save_checkpoint_orbax returns in {return_s:.3f} s, committed after "
              f"{wait_s:.3f} s; read back bit-equal to the pickle {equal}; in-place control "
              f"(the read equals the tree before the update): snapshot {reads['snapshot']}, "
              f"live saver {reads['live']} ({smi_line})", flush=True)
        del before, prm, state
        torch.cuda.empty_cache()
        flags = ["--dp", "2", "--tp", "2", "--zero1", "--ckpt-backend", "orbax"]
        t = time.perf_counter()
        res = pm.launch(ckpt_rank_cli, 4, (CKPT_CLI + flags + [
            "--device", device or "cuda", "--epochs", "1", "--exp-dir", d("e"),
            "--ckpt-dir", d("c")], 4, device), backend=backend, timeout_s=600)
        wall = time.perf_counter() - t
        names = sorted(n for n in os.listdir(d("c")) if not n.endswith(".meta.json"))
        files = ckpt_files(d("c", names[0])) if names else None
        keep = {k: os.environ.get(k) for k in CKPT_ROUTE}
        os.environ.update(CKPT_ROUTE)
        try:
            resumed = cli.main(CKPT_CLI + ["--device", device or "cuda", "--epochs", "2",
                                           "--resume", d("c", names[0]), "--exp-dir", d("e1"),
                                           "--ckpt-dir", d("c1")]) if names else None
        finally:
            for k, v in keep.items():
                os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
        r0 = res[0]
        found.update(cli_counts=[r["f_launches"] for r in res], cli_saves=[r["saves"] for r in res],
                     cli_wall_s=wall, files=files, resumed=resumed and resumed["history"])
        print(f"[ckpt] 45: cli pretrain {' '.join(flags)} over {backend} ({smi_line}): "
              f"{wall:.1f}s with the ranks' start; {r0['steps']} step(s), history "
              f"{r0['history']}; F launches (fwd, bwd) a rank {found['cli_counts']}; each "
              f"rank's save (s to return, to commit) {found['cli_saves']}; checkpoints {names}; "
              f"files per rank {files and files['per_rank']}, writers {files and files['writers']}"
              f"; resumed at pp 1 in this process: history {resumed and resumed['history']}, "
              f"steps {resumed and resumed['steps']}", flush=True)
        if not (r0["steps"] == 1 and r0["history"] and all(math.isfinite(v)
                                                           for v in r0["history"])):
            fails.append(f"the mesh run: {r0['steps']} steps, history {r0['history']}")
        if any(c[0] == 0 or c[1] == 0 for c in found["cli_counts"]):
            fails.append(f"kernel F ran no time on a rank: {found['cli_counts']}")
        if not files or files["writers"] != [0, 1, 2, 3] or any(
                v["bytes"] != v["on_disk"] for v in files["per_rank"].values()):
            fails.append(f"the directory's writers or files: {files}")
        if not (resumed and resumed["steps"] == 1 and len(resumed["history"]) == 1
                and math.isfinite(resumed["history"][0])):
            fails.append(f"the resume at pp 1: {resumed}")
    check(not fails, "ckpt, phase 45: " + "; ".join(fails))
    print(f"[time] phase 45: {time.perf_counter() - t_all:.1f}s ({smi_line})", flush=True)
    return found


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    try:
        from reinforcement_learning_in_music_generation_torch import config as C
        from reinforcement_learning_in_music_generation_torch.apps import cli
        from reinforcement_learning_in_music_generation_torch.data import tokenizer
        from reinforcement_learning_in_music_generation_torch.generate import sampler
        from reinforcement_learning_in_music_generation_torch.models import (
            common as cm, linear_transformer as lt)
        from reinforcement_learning_in_music_generation_torch.ops import (
            _build, decode_kernel_v4 as dk4, decode_kernel_v6 as dk6,
            linear_attention as tla, sampling as smp)
        from reinforcement_learning_in_music_generation_torch import utils as tu
    except ImportError as e:
        fail(f"the port's package is not importable ({e}); run from the repo root")

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"card: {smi_line}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # -- 1. build ---------------------------------------------------------
    t = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t:.1f}s", flush=True)
    for name in libs:                        # ptxas -v: registers and spills per kernel
        log = _build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
        print(f"[build] {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers a thread, {spills} bytes of spill stores")

    e2w, _ = tokenizer.drop_type(tokenizer.construct_cp_dict())
    cfg = C.agent_config(tuple(tokenizer.n_classes(e2w)))
    L, D, H, E, DI = cfg.n_layer, cfg.d_model, cfg.n_head, cfg.d_head, cfg.d_inner
    params = lt.init_params(cfg, seed=0, device=dev)
    dparams = lt.make_decode_params(params, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def rand_tokens(steps, b):
        return torch.stack([torch.randint(0, v, (steps, b), generator=gen, device=dev)
                            for v in cfg.vocab_sizes], dim=-1).to(torch.int32)

    def greedy_next(h):
        logits = lt.fused_logits(dparams, cfg, cm.layernorm(params["final_ln"], h))
        return torch.stack([lg.argmax(-1) for lg in logits], dim=-1)

    # -- 2a. decode_step (v4 counterpart) against its plain version --------
    # (weights, songs, state): f32 weights with the default bf16 state at
    # both batches, an f32 state for the tight check, and bf16 weights (the
    # generate default) at 1 to 128 songs.  At an f32 state a control, the
    # twin with every product's input rounded to bf16 (v6's arithmetic), is
    # held above the gate the kernel is held below: the gate tells f32-grade
    # activations from rounded ones.
    f32, bf16 = torch.float32, torch.bfloat16
    dparams_bf16 = lt.make_decode_params(params, cfg, bf16)
    a_err, a_ctrl = 0.0, float("inf")
    a_calls0, a_cuda0 = dk4.fused_stack_step.launches, dk4.fused_stack_step.cuda_launches
    dk4.kernel_runs(reset=True)
    for wdt, b, sdt in ((f32, 5, f32), (f32, 5, bf16), (f32, 128, f32), (f32, 128, bf16),
                        (bf16, 1, f32), (bf16, 5, f32), (bf16, 5, bf16), (bf16, 32, f32),
                        (bf16, 64, bf16), (bf16, 128, f32)):
        dp = dparams if wdt == f32 else dparams_bf16
        toks = rand_tokens(16, b)
        sk = dk4.init_state(cfg, b, sdt, dev)
        sp = dk4.init_state(cfg, b, sdt, dev)
        sc = dk4.init_state(cfg, b, sdt, dev)
        wk = dk4.workspace(dp, b)
        agree = total = 0
        dh = dc = 0.0
        for t in range(16):
            h0 = lt.embed_input(params, cfg, toks[t], t, None).float()
            hk, _, _ = dk4.fused_stack_step(None, h0, sk.s, sk.z, n_head=H, eps=cfg.attn_eps,
                                            work=wk)
            hp, _, _ = dk4.fused_stack_step_plain(dp, h0, sp.s, sp.z, n_head=H,
                                                  eps=cfg.attn_eps)
            dh = max(dh, (hk - hp).abs().max().item())
            gk, gp = greedy_next(hk), greedy_next(hp)
            agree += (gk == gp).sum().item()
            total += gk.numel()
            if sdt == f32:
                hc, _, _ = dk4.fused_stack_step_plain(dp, h0, sc.s, sc.z, n_head=H,
                                                      eps=cfg.attn_eps, round_to=bf16)
                dc = max(dc, (hc - hp).abs().max().item())
        torch.cuda.synchronize()
        ds = (sk.s.float() - sp.s.float()).abs().max().item()
        rate = agree / total
        tag = f"B={b} weights {str(wdt)[6:]} state {str(sdt)[6:]}"
        ctrl = f", bf16-rounding control max|dh| {dc:.3e}" if sdt == f32 else ""
        print(f"[decode_step] {tag}: max|dh| {dh:.3e}, max|ds| {ds:.3e}, "
              f"greedy agreement {rate:.4%}{ctrl}", flush=True)
        if sdt == f32:
            check(dh <= 1e-3, f"decode_step {tag}: max|dh| {dh} > 1e-3")
            check(dc > 1e-3, f"decode_step {tag}: the bf16-rounding control {dc} is not "
                             "above the 1e-3 gate")
            a_err = max(a_err, dh)
            a_ctrl = min(a_ctrl, dc)
        else:
            check(rate >= 0.99, f"decode_step {tag}: agreement {rate} < 99%")
    a_calls = dk4.fused_stack_step.launches - a_calls0
    a_cuda_per_token = (dk4.fused_stack_step.cuda_launches - a_cuda0) / max(1, a_calls)
    a_runs_per_token = dk4.kernel_runs() / max(1, a_calls)
    print(f"[decode_step] {a_calls} calls, {a_cuda_per_token:g} CUDA launches a token (every "
          f"layer in one cooperative launch), {a_runs_per_token:g} runs a token as the kernel "
          f"counts them; the control's least max|dh| {a_ctrl:.3e}", flush=True)
    check(a_cuda_per_token == 1 and a_runs_per_token == 1,
          f"decode_step: {a_cuda_per_token} CUDA launches and {a_runs_per_token} kernel runs "
          "a token")

    # every product of A's and v3's token kernel on the tensor cores: HMMA in
    # the SASS of their instantiations (bf16 weights: three bf16 products a
    # product, f32 weights six)
    cuobjdump = cuobjdump_path()
    check(cuobjdump is not None, "cuobjdump not found (toolkit or Triton's copy)")
    stack_mma = {}
    for lib in ("decode_step", "decode_aug"):
        sass = subprocess.run([cuobjdump, "-sass", libs[lib]], capture_output=True, text=True,
                              timeout=300)
        check(sass.returncode == 0, f"cuobjdump -sass failed: {sass.stderr[-500:]}")
        stack_mma.update({f"{lib}:{k}": n
                          for k, n in mma_counts(sass.stdout, "stack_tc_kernel").items()})
    print(f"[decode_step] HMMA instructions in the token kernel's instantiations (A: "
          f"decode_step, v3: decode_aug): {stack_mma}", flush=True)
    # bf16-weight instantiations: A's two (bf16 and f32 state), v3's and
    # v2's (the tanh gelu's) in decode_aug
    stack_bf16 = {k: n for k, n in stack_mma.items() if "stack_tc_kernelI13__nv_bfloat16" in k}
    check(len(stack_bf16) == 4 and all(n > 0 for n in stack_bf16.values()),
          f"decode_step / v3: no tensor-core instructions in the bf16-weight kernels "
          f"{stack_bf16}")

    # -- 2b. decode_chunk (v6 counterpart) against its plain version -------
    # both weight types take the tensor-core route: f32 weights at f32 grade
    # (three bf16 planes an operand, six products), bf16 weights (generate's
    # default) at v6's cast; the twin computes v6's arithmetic for both
    v6p = dk6.make_v6_params(params, cfg)
    b6 = 128
    temps = tuple(s.temperature for s in smp.CP_SAMPLING)
    topps = tuple(s.top_p if s.top_p is not None else float("inf") for s in smp.CP_SAMPLING)
    kw = dict(n_head=H, vocab_sizes=cfg.vocab_sizes, temps=temps, topps=topps,
              eps=cfg.attn_eps)
    b_err, b_share = {}, {}
    dk6.reset_counts()
    toks = rand_tokens(16, b6)
    v6p_bf16 = dk6.make_v6_params(params, cfg, dtype=bf16)
    for wdt, sdt in ((f32, f32), (f32, bf16), (bf16, f32), (bf16, bf16)):
        vp = v6p if wdt == f32 else v6p_bf16
        sk = dk4.init_state(cfg, b6, sdt, dev)
        sp = dk4.init_state(cfg, b6, sdt, dev)
        agree = total = 0
        for t in range(16):
            ok, _, _ = dk6.fused_decode_v6(vp, toks[t], sk.s, sk.z, t, 7, max_tokens=1,
                                           greedy=True, **kw)
            op, _, _ = dk6.fused_decode_v6_plain(vp, toks[t], sp.s, sp.z, t, 7,
                                                 max_tokens=1, greedy=True, n_head=H,
                                                 temps=temps, topps=topps, eps=cfg.attn_eps)
            agree += (ok == op).sum().item()
            total += ok.numel()
        rate = agree / total
        ds = (sk.s.float() - sp.s.float()).abs().max().item()
        mag = sp.s.float().abs().max().item()
        tag = f"B={b6} weights {str(wdt)[6:]} state {str(sdt)[6:]}"
        print(f"[decode_chunk] {tag}: teacher-forced greedy agreement {rate:.4%}, "
              f"max|ds| {ds:.3e} (max|s| {mag:.3e})", flush=True)
        check(rate >= 0.99, f"decode_chunk {tag}: agreement {rate} < 99%")
        if sdt == f32:
            # f32 weights: f32-grade products on both sides, the sums in
            # another order: 1e-4.  bf16 weights: both sides also round the
            # activations to bf16, so a reordered sum can flip a rounding:
            # 3e-4, under what a state rounded to bf16 reads (the control
            # below)
            tol = 1e-4 if wdt == f32 else S_TC_TOL
            check(ds <= tol * max(1.0, mag), f"decode_chunk {tag}: max|ds| {ds} > {tol} x "
                                             f"{mag}")
            b_err[wdt] = ds
            b_share[wdt] = ds / max(1.0, mag)
            if wdt == f32:
                s_twin_f32w = sp.s.float()
            else:
                s_ref_f32 = sp.s.float()
                # the f32 weights' control: the route on the same weights
                # rounded to bf16, against the f32 weights' twin
                ctl = (sk.s.float() - s_twin_f32w).abs().max().item()
                mag_w = max(1.0, s_twin_f32w.abs().max().item())
                b_share["control_f32_weights"] = ctl / mag_w
                print(f"[decode_chunk] control, B={b6} weights rounded to bfloat16, f32 state, "
                      f"against the f32 weights' twin: max|ds| {ctl:.3e} = {ctl / mag_w:.3e} of "
                      f"max|s| (gate 1e-4; the f32 weights' route reads {b_share[f32]:.3e})",
                      flush=True)
                check(ctl > 1e-4 * mag_w, "decode_chunk: the f32 weights' gate would pass bf16 "
                                          f"weights ({ctl} <= 1e-4 x {mag_w})")
                del s_twin_f32w
        elif wdt == bf16:
            # the control: the route with its state rounded to bf16, against
            # the f32-state twin the gate above reads
            ctl = (sk.s.float() - s_ref_f32).abs().max().item()
            mag_ref = max(1.0, s_ref_f32.abs().max().item())
            print(f"[decode_chunk] control, B={b6} weights bfloat16 state rounded to bfloat16, "
                  f"against the f32-state twin: max|ds| {ctl:.3e} = {ctl / mag_ref:.3e} of max|s| "
                  f"(gate {S_TC_TOL:g}; the f32-state route reads {b_err[bf16] / mag_ref:.3e})",
                  flush=True)
            check(ctl > S_TC_TOL * mag_ref, "decode_chunk: the f32-state gate would pass a state "
                                            f"rounded to bf16 ({ctl} <= {S_TC_TOL} x {mag_ref})")
            del s_ref_f32
    f6 = dk6.fused_decode_v6
    check(f6.tc_calls == f6.launches == 64, "decode_chunk: the checks did not all take the "
          f"tensor-core route ({f6.tc_calls} of {f6.launches} calls, 64 made)")

    # chunk invariance at both weight types: 64 tokens in one call equal 2 x 32
    tok0 = torch.tensor(sampler.CP_SEED, dtype=torch.int32, device=dev).repeat(b6, 1)
    for vp in (v6p, v6p_bf16):
        s1 = dk4.init_state(cfg, b6, device=dev)
        s2 = dk4.init_state(cfg, b6, device=dev)
        one, _, _ = dk6.fused_decode_v6(vp, tok0, s1.s, s1.z, 0, 99, max_tokens=64, **kw)
        first, _, _ = dk6.fused_decode_v6(vp, tok0, s2.s, s2.z, 0, 99, max_tokens=32, **kw)
        second, _, _ = dk6.fused_decode_v6(vp, first[-1].contiguous(), s2.s, s2.z, 32, 99,
                                           max_tokens=32, **kw)
        same = torch.equal(one, torch.cat([first, second])) and torch.equal(s1.s, s2.s) \
            and torch.equal(s1.z, s2.z)
        route = "f32 weights" if vp is v6p else "bf16 weights"
        print(f"[decode_chunk] chunk invariance ({route}; 64 vs 2x32 tokens, B={b6}): "
              f"{'identical' if same else 'DIFFERENT'}", flush=True)
        check(same, f"decode_chunk ({route}): one call of 64 tokens differs from two of 32")

    # a whole 128-token call (the main path's chunk) feeds each token back:
    # greedy with an f32 state, the streams agree until a near-tie flips one
    # (with bf16 weights a flip comes within a few tokens, so that stream's
    # agreement is printed, not gated)
    for vp in (v6p, v6p_bf16):
        sk = dk4.init_state(cfg, b6, torch.float32, dev)
        sp = dk4.init_state(cfg, b6, torch.float32, dev)
        gk, _, _ = dk6.fused_decode_v6(vp, tok0, sk.s, sk.z, 0, 0, max_tokens=128,
                                       greedy=True, **kw)
        gp, _, _ = dk6.fused_decode_v6_plain(vp, tok0, sp.s, sp.z, 0, 0, max_tokens=128,
                                             greedy=True, n_head=H, temps=temps, topps=topps,
                                             eps=cfg.attn_eps)
        rate = (gk == gp).float().mean().item()
        wname = "f32" if vp is v6p else "bf16"
        print(f"[decode_chunk] greedy 128-token call, B={b6}, {wname} weights, f32 state: "
              f"{rate:.4%} of tokens equal to the plain version", flush=True)
        if vp is v6p:
            check(rate >= 0.95, f"decode_chunk greedy 128-token call: {rate} < 95% equal")

    # the route's products run on the tensor cores at both weight types:
    # HMMA in the SASS of its product kernels (four instantiations a weight
    # type); and kernel E's three passes at each compiled depth
    cuobjdump = cuobjdump_path()
    check(cuobjdump is not None, "cuobjdump not found (toolkit or Triton's copy)")
    sass = subprocess.run([cuobjdump, "-sass", libs["decode_chunk"]], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump -sass failed: {sass.stderr[-500:]}")
    b_mma = mma_counts(sass.stdout, "tc_gemm_kernel")
    b_mma_f32 = {k: n for k, n in b_mma.items() if "EfEEv" in k}
    print(f"[decode_chunk] HMMA/HGMMA instructions in the route's product kernels "
          f"({cuobjdump}): {b_mma}", flush=True)
    check(len(b_mma) == 8 and len(b_mma_f32) == 4 and all(n > 0 for n in b_mma.values()),
          f"decode_chunk: a product kernel without tensor-core instructions, or not one "
          f"instantiation a tile, epilogue and weight type ({b_mma})")
    sass = subprocess.run([cuobjdump, "-sass", libs["window_attention"]], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump -sass failed: {sass.stderr[-500:]}")
    e_mma = mma_counts(sass.stdout, "wa_")
    print(f"[window_attn] HMMA instructions in kernel E's passes: {e_mma}", flush=True)
    # each pass at four depths for f32 and for bf16 tensors
    check(all(sum(n > 0 and name in k for k, n in e_mma.items()) == 8
              and sum(n > 0 and name in k and "__nv_bfloat16" in k for k, n in e_mma.items()) == 4
              for name in ("wa_fwd_kernel", "wa_dq_kernel", "wa_dkv_kernel")),
          f"window_attn: a pass without tensor-core instructions at some depth or type ({e_mma})")

    hfix = torch.randn((b6, D), generator=gen, device=dev)
    for greedy in (False, True):
        hk = dk6.heads_sample(v6p, hfix, seed=5, pos=3, temps=temps, topps=topps,
                              greedy=greedy)
        hp = dk6.heads_sample_plain(v6p, hfix, seed=5, pos=3, temps=temps, topps=topps,
                                    greedy=greedy)
        rate = (hk == hp).float().mean().item()
        print(f"[decode_chunk] heads+sample on fixed h ({'greedy' if greedy else 'CP sampling'}"
              f"): {rate:.4%} of tokens equal", flush=True)
        check(rate >= 0.99, f"heads+sample: agreement {rate} < 99%")

    # -- 3. the main path, end to end -------------------------------------
    # generate's default bf16 weights at 5 songs (kernel A) and 128 (kernel
    # B), and 128 songs with --dtype float32 (kernel B at f32 grade); both
    # of B's runs must reach its tensor-core route
    launches, tc_launch = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, songs, max_tok, dtype in (("v4", 5, 512, "bfloat16"),
                                            ("v6_tc", 128, 256, "bfloat16"),
                                            ("v6", 128, 256, "float32")):
            out = os.path.join(tmp, name, "midis")
            dk4.fused_stack_step.launches = 0
            dk4.kernel_runs(reset=True)
            dk6.reset_counts()
            # kernel B: a warm request on seed 1, then the timed one on seed 0,
            # a new request
            warm = ["--warmup"] if name != "v4" else []
            res = cli.main(["generate", "--songs", str(songs), "--bars", "8",
                            "--max-tokens", str(max_tok), "--dtype", dtype, "--out-dir", out,
                            *warm])
            torch.cuda.synchronize()
            f6 = dk6.fused_decode_v6
            a_runs = dk4.kernel_runs()
            launches[name] = a_runs if name == "v4" else f6.tc_calls
            cold = " (a cold call: it captures the token graph)" if name == "v4" else ""
            print(f"[generate] {songs} songs, {dtype} weights: {res['tokens']} tokens in "
                  f"{res['seconds']:.3f}s = {res['tokens_per_s']:.1f} tokens/s{cold}; launches "
                  f"decode_step {a_runs} (counted by the kernel; "
                  f"{dk4.fused_stack_step.launches} eager), decode_chunk {f6.launches} calls, "
                  f"on the tensor cores {f6.tc_calls} ({f6.cuda_launches} "
                  f"CUDA launches for {f6.positions} positions, {f6.graph_kernels} kernels in a "
                  f"token's graph, {f6.captures} instantiated, {f6.updates} updated)",
                  flush=True)
            check(launches[name] > 0, f"generate {songs} songs {dtype}: its kernel never "
                                      "launched")
            if name != "v4":
                check(f6.launches == f6.tc_calls > 0, f"generate 128 songs {dtype}: "
                      f"{f6.tc_calls} of {f6.launches} calls reached the tensor-core route")
                check(f6.captures <= 1, f"generate 128 songs {dtype}: {f6.captures} token "
                                        "graphs instantiated for two requests of one shape")
                check(f6.cuda_launches == f6.tc_calls + f6.positions,
                      f"generate 128 songs {dtype}: {f6.cuda_launches} CUDA launches for "
                      f"{f6.tc_calls} calls of {f6.positions} positions (1 + T a call)")
                tc_launch[name] = dict(cuda_launches=f6.cuda_launches, positions=f6.positions,
                                       graph_kernels=f6.graph_kernels, captures=f6.captures,
                                       updates=f6.updates, tokens_per_s=res["tokens_per_s"])
            for i in range(songs):
                with open(os.path.join(out, f"get_{i}.mid"), "rb") as f:
                    head = f.read(4)
                check(head == b"MThd", f"generate {songs} songs: get_{i}.mid is not a MIDI")
            check(res["songs"] == songs and res["tokens"] >= songs, "generate: no tokens")

    # -- 3b. the per-step path's token graph, 5 songs, 64 tokens -----------
    # one graph replay a token: the host's launches a token (was about 208:
    # A's 108 and PyTorch's sampling, embedding and final LN), the replays,
    # the device's busy share, for f32 and bf16 (generate's default) weights
    p16 = lt.cast_params(params, bf16)
    graph_win = {}
    for name, p_ in (("float32", params), ("bfloat16", p16)):
        w = token_graph_window(sampler, p_, cfg, dev)
        graph_win[name] = w
        print(f"[generate] per-step token graph, 5 songs, {w['tokens']} tokens, {name} "
              f"weights: wall {w['wall_ms']:.3f} ms, device {w['device_ms']:.3f} ms (union "
              f"{w['union_ms']:.3f}), busy {w['busy']:.1%}; {w['device_kernels']} device "
              f"kernels; host launches {w['host_launches']} = "
              f"{w['host_launches_per_token']:.3f} a token {w['host_calls']}; graph replays "
              f"{w['replays']}, captures {w['captures']}; kernel A's runs (counted by the "
              f"kernel) {w['kernel_runs']} = {w['kernel_runs'] / w['tokens']:g} a token, of "
              f"them eager launches {w['eager_launches']}; the cached token graph holds "
              f"{w['graph_bytes']} bytes of device memory", flush=True)
        check(w["replays"] == w["tokens"] - 1 and w["captures"] == 0,
              f"per-step token graph ({name}): {w['replays']} replays, {w['captures']} "
              "captures in a warm window")
        # one run of the token kernel a replay, as the kernel counts them
        check(w["kernel_runs"] == w["tokens"] == w["replays"] + w["eager_launches"],
              f"per-step token graph ({name}): kernel A ran {w['kernel_runs']} times for "
              f"{w['tokens']} tokens ({w['replays']} replays, {w['eager_launches']} eager)")
        check(0 < w["host_launches_per_token"] < 20,
              f"per-step token graph ({name}): {w['host_launches_per_token']} host launches "
              "a token")

    # -- 4. the training kernels against their plain versions -------------
    from reinforcement_learning_in_music_generation_torch.data import dataset
    from reinforcement_learning_in_music_generation_torch.models import longformer as lf
    from reinforcement_learning_in_music_generation_torch.ops import (
        attention_block as tab, ffn_block as tfb, linear_attention_kernel as tlk,
        window_attention_kernel as twk)
    from reinforcement_learning_in_music_generation_torch.train import (
        optim as topt, pretrain as tpre)
    BT, ST, CHUNK = 32, 512, cfg.attn_chunk
    NT = BT * ST
    lp0 = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in params["layers"].items()}
    wqkv = torch.cat([lp0["wq"]["w"], lp0["wk"]["w"], lp0["wv"]["w"]], -1).contiguous()
    bqkv = torch.cat([lp0["wq"]["b"], lp0["wk"]["b"], lp0["wv"]["b"]]).contiguous()
    h_tr = torch.randn((NT, D), generator=gen, device=dev)
    g_tr = torch.randn((NT, D), generator=gen, device=dev)
    c_in = (h_tr, wqkv, bqkv)
    c_kernel = lambda h_, w_, b_: tab.qkv_attention_block(h_, w_, b_, BT, H, chunk=CHUNK)
    c_plain = lambda h_, w_, b_: tab.qkv_attention_block_plain(h_, w_, b_, BT, H, chunk=CHUNK)
    ok, gk = fwd_bwd(c_kernel, c_in, g_tr)
    op, gp = fwd_bwd(c_plain, c_in, g_tr)
    c_err = max_err(ok, op)
    c_out = op
    print(f"[qkv_attention] B={BT} S={ST} D={D} H={H} chunk {CHUNK}: max|d att| {c_err:.3e} "
          f"(max|att| {magnitude(op):.3e})", flush=True)
    check(c_err <= 1e-4 * magnitude(op), f"qkv_attention forward: max|d att| {c_err}")
    for name, x, y in zip(("dh", "dWqkv", "dbqkv"), gk, gp):
        e = max_err(x, y)
        print(f"[qkv_attention] {name}: max|diff| {e:.3e} of magnitude {magnitude(y):.3e}",
              flush=True)
        check(e <= 1e-3 * magnitude(y), f"qkv_attention {name}: max|diff| {e}")
    del gk, gp
    # bf16 tensors against the twin of JAX's bf16 arithmetic (f32 projection
    # and attention, stores rounded): every tensor within C_BF16_GATES, the
    # rounded-residual control (the parent kernel's fault) above them; the
    # parent's plain arithmetic (the projection and every attention product
    # rounded to bf16) printed beside
    c_in16 = as_bf16(c_in)
    c_read = qkv_bf16_readings(tab, *c_in16, g_tr.bfloat16(), BT, H, CHUNK)
    op, gp = fwd_bwd(c_plain, c_in16, g_tr.bfloat16())
    oc, gc = fwd_bwd(lambda h_, w_, b_: parent_qkv_attention(h_, w_, b_, BT, H, CHUNK), c_in16,
                     g_tr.bfloat16())
    c_share_bf16 = {}
    for name, y, z in zip(C_BF16_GATES, (op, *gp), (oc, *gc)):
        r = c_read[name]
        ctl = bf16_shares(z, y)
        c_share_bf16[name] = {"share": r["kernel"][0], "mean_share": r["kernel"][1],
                              "rounded_residual_control": r["control"],
                              "parent_arithmetic": ctl, "gate": C_BF16_GATES[name]}
        print(f"[qkv_attention] bf16 {name}: max / mean share {r['kernel'][0]:.3e} / "
              f"{r['kernel'][1]:.3e} (gate {C_BF16_GATES[name][0]:.3e} / "
              f"{C_BF16_GATES[name][1]:.3e}); the rounded-residual control "
              f"{r['control'][0]:.3e} / {r['control'][1]:.3e}; the parent's arithmetic "
              f"{ctl[0]:.3e} / {ctl[1]:.3e}", flush=True)
    for msg in qkv_bf16_gate_failures(c_read):
        fail(f"qkv_attention bf16 {msg}")
    del op, gp, oc, gc, c_in16

    def tail_weights(lp):
        return [t.contiguous() for t in (
            lp["wo"]["w"], lp["wo"]["b"], lp["ln1"]["scale"], lp["ln1"]["bias"], lp["ffn1"]["w"],
            lp["ffn1"]["b"], lp["ffn2"]["w"], lp["ffn2"]["b"], lp["ln2"]["scale"],
            lp["ln2"]["bias"])]

    tail_ws = tail_weights(lp0)
    seed_t = torch.tensor(20260, dtype=torch.int32, device=dev)
    d_in = (h_tr, c_out.contiguous(), *tail_ws)
    d_err = check_tail(f"attn_tail N={NT} D={D} DI={DI}", tfb, d_in, g_tr, seed_t, True)
    # bf16 tensors against the twin of JAX's bf16 arithmetic
    d_err_bf16 = check_tail(f"attn_tail N={NT} D={D} DI={DI} bf16", tfb, as_bf16(d_in),
                            g_tr.bfloat16(), seed_t, True, (BF16_TOL, BF16_TOL))
    # every product of D and G on the tensor cores: HMMA in the SASS of
    # their product kernels, at both arithmetics
    dg_mma = {}
    for name in ("attn_tail", "ffn_block"):
        sass = subprocess.run([cuobjdump, "-sass", libs[name]], capture_output=True, text=True,
                              timeout=300)
        check(sass.returncode == 0, f"cuobjdump -sass {name} failed: {sass.stderr[-500:]}")
        mma = mma_counts(sass.stdout, "tt_gemm_kernel")
        dg_mma[name] = {"kernels": len(mma), "hmma_min": min(mma.values(), default=0),
                        "hmma_max": max(mma.values(), default=0)}
        print(f"[{name}] HMMA instructions in its {len(mma)} product kernels: "
              f"{min(mma.values(), default=0)} to {max(mma.values(), default=0)} each",
              flush=True)
        check(len(mma) >= 6 and all(n > 0 for n in mma.values()),
              f"{name}: a product kernel without tensor-core instructions ({mma})")
    # C's projection on warpgroup MMA: HGMMA in the SASS of its product
    # kernel at both arithmetics
    sass = subprocess.run([cuobjdump, "-sass", libs["attention_block"]], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump -sass attention_block failed: {sass.stderr[-500:]}")
    c_mma = mma_counts("\n".join(line for line in sass.stdout.splitlines()
                                 if "Function :" in line or "HGMMA" in line), "wg_gemm_kernel")
    print(f"[qkv_attention] HGMMA instructions in its {len(c_mma)} projection kernels: "
          f"{sorted(c_mma.values())}", flush=True)
    check(len(c_mma) == 2 and all(n > 0 for n in c_mma.values()),
          f"qkv_attention: a projection kernel without warpgroup MMA ({c_mma})")

    # -- 5. one full-width train step, kernel route against plain route ----
    knobs = ("RLMG_FFN_BACKEND", "RLMG_ATTN_BACKEND", "RLMG_FFN_MIN_ROWS", "RLMG_WINDOW_BACKEND")
    saved_env = {k: os.environ.get(k) for k in knobs}

    def set_env(env):
        for k in knobs:
            os.environ.pop(k, None)
        os.environ.update(env)

    def restore_env():
        for k, v in saved_env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v

    counters = train_counters()

    def zero_counts():
        for fn, attr in counters:
            setattr(fn, attr, 0)

    def read_counts():
        return [getattr(fn, attr) for fn, attr in counters]

    def route_step(env, p0, mcfg, batch, grad_step, train_step):
        """One step from p0 on a route -> ((loss, per-field losses, params
        after Adam, grads, Adam updates), that step's kernel counts, ms per
        step of two more)."""
        set_env(env)
        prm = topt.tree_map(torch.clone, p0)
        tx = topt.adam(1e-4, grad_clip=3.0)
        state = tx.init(prm)
        zero_counts()
        grads, (loss, losses) = grad_step(prm, mcfg, *batch, None)
        updates, _ = tx.update(grads, state, prm)     # pure: what apply_grads adds
        prm, state = tpre.apply_grads(prm, state, tx, grads)
        torch.cuda.synchronize()
        counts = read_counts()
        out = (float(loss), losses.cpu(), named_leaves(prm), named_leaves(grads),
               named_leaves(updates))
        del grads, updates
        t = time.perf_counter()
        for _ in range(2):
            prm, state, _ = train_step(prm, state, mcfg, tx, *batch, None)
        torch.cuda.synchronize()
        return out, counts, (time.perf_counter() - t) / 2 * 1e3

    tcfg = C.agent_config(cfg.vocab_sizes, dropout=0.0)
    p0 = lt.init_params(tcfg, seed=0, device=dev)
    xs, ys, ms = (torch.from_numpy(a).to(dev) for a in
                  dataset.synthetic_cp_dataset(BT, ST, n_class=cfg.vocab_sizes, seed=0))
    routes = {"kernel": {}, "plain": {"RLMG_FFN_BACKEND": "xla", "RLMG_ATTN_BACKEND": "xla"}}
    step_out, step_ms = {}, {}
    for name in ("kernel", "plain"):
        step_out[name], counts, step_ms[name] = route_step(
            routes[name], p0, tcfg, (xs.long(), ys.long(), ms), tpre.agent_grad_step,
            tpre.agent_train_step)
        print(f"[train_step] {name} route: loss {step_out[name][0]:.6f}, kernel launches "
              f"(C, D, E, F, G fwd/bwd) {counts}, {step_ms[name]:.1f} ms/step, "
              f"{NT / step_ms[name] * 1e3:.1f} tokens/s", flush=True)
        want = [tcfg.n_layer] * 4 + [0] * 6 if name == "kernel" else [0] * 10
        check(counts == want, f"train step, {name} route: launches {counts}, expected {want}")
    restore_env()
    check_step("train_step", step_out["kernel"], step_out["plain"])
    del step_out

    # -- 5b. remat: the step with every layer under torch.utils.checkpoint --
    # C + D (the default route at 16384 rows), dropout 0.1, f32 and bf16, the
    # same generator seed with and without remat: loss and gradients under
    # phase 5's checks, the generator's state after the step equal (the
    # recompute replays each layer's dropout seeds), C's and D's forward
    # counters at two calls a layer and step (the recompute), backward at
    # one; the peak device memory of the remat step below the other's
    remat_t = {}
    for dt in ("float32", "bfloat16"):
        rr = {}
        for r in (False, True):
            mcfg = C.agent_config(cfg.vocab_sizes, dropout=0.1, remat=r, dtype=dt)
            set_env(routes["kernel"])
            prm = topt.tree_map(torch.clone, p0)
            gen_r = torch.Generator(device=dev)
            gen_r.manual_seed(4321)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            zero_counts()
            grads, (loss, _) = tpre.agent_grad_step(prm, mcfg, xs.long(), ys.long(), ms, gen_r)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            counts = read_counts()
            rr[r] = dict(loss=float(loss), grads=named_leaves(grads), state=gen_r.get_state(),
                         peak=peak, peak_above_resident=peak - before, counts=counts)
            del grads
            t = time.perf_counter()
            for _ in range(2):
                tpre.agent_grad_step(prm, mcfg, xs.long(), ys.long(), ms, gen_r)
            torch.cuda.synchronize()
            rr[r]["ms"] = (time.perf_counter() - t) / 2 * 1e3
            del prm
        restore_env()
        a, b = rr[False], rr[True]
        rel = abs(b["loss"] - a["loss"]) / abs(a["loss"])
        g_worst = max((max_err(b["grads"][k], a["grads"][k])
                       / max(a["grads"][k].abs().max().item(), 1e-30), k) for k in a["grads"])
        print(f"[remat] {dt}, C + D, dropout 0.1: loss {b['loss']:.7f} with remat, "
              f"{a['loss']:.7f} without ({'bit-equal' if b['loss'] == a['loss'] else 'relative'} "
              f"{rel:.2e}); gradients: worst max|diff| / leaf magnitude {g_worst[0]:.3e} "
              f"({g_worst[1]}); generator state after the step "
              f"{'equal' if torch.equal(a['state'], b['state']) else 'DIFFERENT'}; peak device "
              f"memory {b['peak'] / 2**20:.1f} MiB with remat, {a['peak'] / 2**20:.1f} without "
              f"({b['peak_above_resident'] / 2**20:.1f} / {a['peak_above_resident'] / 2**20:.1f} "
              f"MiB above what was resident); {b['ms']:.1f} / {a['ms']:.1f} ms a step "
              f"(gradients only); launches (C, D, E, F, G fwd/bwd) {b['counts']} / {a['counts']} "
              f"({smi_line})", flush=True)
        L2 = tcfg.n_layer
        check(a["counts"] == [L2] * 4 + [0] * 6 and
              b["counts"] == [2 * L2, L2, 2 * L2, L2] + [0] * 6,
              f"remat {dt}: launches {b['counts']} with remat, {a['counts']} without")
        check(rel <= 1e-4, f"remat {dt}: losses differ by {rel} relative")
        check(g_worst[0] <= 1e-3, f"remat {dt}: gradient {g_worst[1]} differs by {g_worst[0]}")
        check(torch.equal(a["state"], b["state"]), f"remat {dt}: the generator ends elsewhere")
        check(b["peak"] < a["peak"], f"remat {dt}: peak {b['peak']} not below {a['peak']}")
        remat_t[dt] = {f"{k}_{'remat' if r else 'plain'}": v for r, d_ in rr.items()
                       for k, v in d_.items() if k in ("loss", "peak", "peak_above_resident", "ms")}
        del rr, a, b
    del p0

    # -- 6. the training main path: cli pretrain, 4 steps at B=32 x S=512 ---
    # (route, dtype): the kernel route also at --dtype bfloat16 (C + D on
    # bf16 tensors, float32 master weights)
    cli_res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, dt in (("kernel", "float32"), ("plain", "float32"), ("kernel", "bfloat16")):
            set_env(routes[name])
            zero_counts()
            tab.kernel_runs(reset=True)
            res = cli.main(["pretrain", "--synthetic", "--synthetic-songs", "64",
                            "--batch-size", str(BT), "--seq-len", str(ST), "--max-steps", "4",
                            "--dtype", dt, "--exp-dir", os.path.join(tmp, name + dt, "exp"),
                            "--ckpt-dir", os.path.join(tmp, name + dt, "ckpt")])
            torch.cuda.synchronize()
            counts = read_counts()
            c_runs = tab.kernel_runs()
            cli_res[name, dt] = (res, counts, c_runs)
            ms_step = res["seconds"] / res["steps"] * 1e3
            print(f"[pretrain] {name} route, {dt}: {res['steps']} steps in {res['seconds']:.3f}s "
                  f"= {ms_step:.1f} ms/step, {res['tokens_per_s']:.1f} tokens/s (with one "
                  f"epoch-end checkpoint); logged losses {res['batch_losses']}; launches "
                  f"(C, D, E, F, G fwd/bwd) {counts}; C's attention runs as it counts them "
                  f"{c_runs}", flush=True)
            check(res["steps"] == 4, f"pretrain {name} {dt}: {res['steps']} steps, expected 4")
            check(len(res["batch_losses"]) > 0 and all(
                math.isfinite(v) for v in res["batch_losses"] + res["history"]),
                f"pretrain {name} {dt}: a logged loss is not finite")
            want = [12 * 4] * 4 + [0] * 6 if name == "kernel" else [0] * 10
            check(counts == want, f"pretrain {name} {dt}: launches {counts}, expected {want}")
            check(c_runs == tuple(want[:2]), f"pretrain {name} {dt}: C counted {c_runs} runs, "
                                             f"expected {tuple(want[:2])}")
        # kernel F on bf16 tensors: --dtype bfloat16 under RLMG_ATTN_BACKEND=pallas
        # (the unfused layer, its attention kernel F at every layer), then
        # one profiled step of that route under utils.profile_trace
        set_env({"RLMG_ATTN_BACKEND": "pallas"})
        zero_counts()
        tlk.kernel_runs(reset=True)
        res = cli.main(["pretrain", "--synthetic", "--synthetic-songs", "64", "--batch-size",
                        str(BT), "--seq-len", str(ST), "--max-steps", "4", "--dtype", "bfloat16",
                        "--exp-dir", os.path.join(tmp, "f16", "exp"),
                        "--ckpt-dir", os.path.join(tmp, "f16", "ckpt")])
        torch.cuda.synchronize()
        counts = read_counts()
        f_runs16 = tlk.kernel_runs()
        ms_step = res["seconds"] / res["steps"] * 1e3
        print(f"[pretrain] kernel-F route, bfloat16: {res['steps']} steps in {res['seconds']:.3f}s "
              f"= {ms_step:.1f} ms/step, {res['tokens_per_s']:.1f} tokens/s; logged losses "
              f"{res['batch_losses']}; launches (C, D, E, F, G fwd/bwd) {counts}; F's runs as it "
              f"counts them {f_runs16}", flush=True)
        check(res["steps"] == 4, f"pretrain on kernel F's route, bf16: {res['steps']} steps")
        check(len(res["batch_losses"]) > 0 and all(
            math.isfinite(v) for v in res["batch_losses"] + res["history"]),
            "pretrain on kernel F's route, bf16: a logged loss is not finite")
        want = [0] * 6 + [12 * 4, 12 * 4, 0, 0]
        check(counts == want, f"pretrain on kernel F's route, bf16: launches {counts}, expected "
                              f"{want}")
        check(list(f_runs16) == want[6:8], f"pretrain on kernel F's route, bf16: F counted "
                                           f"{f_runs16} runs")
        launches["F_bf16"] = counts[6:8]
        pcfg = C.agent_config(cfg.vocab_sizes, dtype="bfloat16")
        prm = lt.init_params(pcfg, seed=0, device=dev)
        ptx = topt.adam(1e-4, grad_clip=3.0)
        pst = ptx.init(prm)
        gen_p = torch.Generator(device=dev)
        gen_p.manual_seed(0)
        prm, pst, _ = tpre.agent_train_step(prm, pst, pcfg, ptx, xs.long(), ys.long(), ms, gen_p)
        trace_dir = os.path.join(tmp, "trace")
        with tu.profile_trace(trace_dir):
            tpre.agent_train_step(prm, pst, pcfg, ptx, xs.long(), ys.long(), ms, gen_p)
            torch.cuda.synchronize()
        f16_top = tu.summarize_trace(trace_dir, top=5)
        print("[pretrain] kernel-F route, bfloat16, one profiled step: the top five kinds of "
              "device time " + "; ".join(f"{k} {us:.1f} us ({n:g} calls)" for k, us, n in f16_top),
              flush=True)
        f16_kinds = [k for k, _, _ in tu.summarize_trace(trace_dir, top=1000)]
        print(f"[pretrain] the profiled step's kinds: {len(f16_kinds)}, kernel F's passes "
              f"{[k for k in f16_kinds if 'cpk::' in k]}", flush=True)
        del prm, pst
    restore_env()
    launches["C"] = list(cli_res["kernel", "float32"][2])
    launches["C_bf16"] = list(cli_res["kernel", "bfloat16"][2])
    launches["D"] = cli_res["kernel", "float32"][1][2:4]
    launches["D_bf16"] = cli_res["kernel", "bfloat16"][1][2:4]

    # -- 7. kernel E against its plain twin at the discriminator LM's shape --
    dvocab = (56, 135, 18, 87, 18, 25)          # discrim-pretrain without --with-type
    dcfg = C.discrim_lm_config(dvocab, emb_sizes=(128, 256, 64, 512, 256, 128), dropout=0.0)
    BD, SD, WIN = 4, 3584, dcfg.attention_window
    ND, HD, ED, WD = BD * SD, dcfg.n_head, dcfg.d_head, WIN // 2
    dxs, dys, dms = (torch.from_numpy(a).to(dev) for a in
                     dataset.synthetic_cp_dataset(BD, SD, n_class=dvocab, seed=0))
    m_long = torch.ones((BD, SD), device=dev)
    m_long[:, SD - 1000:] = 0.0                 # every song: 1000 padded rows > w = 256
    print(f"[window_attn] synthetic padding per song: "
          f"{(SD - dms.sum(1)).int().tolist()} rows (w = {WD})", flush=True)
    pos = torch.arange(SD, device=dev)
    band = (pos[:, None] - pos[None, :]).abs() <= WD

    def band_inputs():
        """q, k, v, dO in the layout the Longformer passes: (B, H, S, D)
        views of (B, S, H, D) tensors."""
        return [torch.randn((BD, SD, HD, ED), generator=gen, device=dev).transpose(1, 2)
                for _ in range(4)]

    e_kernel = lambda mask: (lambda *a: twk.window_attention_band(*a, mask, WIN))
    e_plain = lambda mask: (lambda *a: twk.window_attention_band_plain(*a, mask, WIN)[0])
    e_err = 0.0
    for tag, mask in (("synthetic padding", dms), ("padding tail 1000 > w", m_long)):
        q_e, k_e, v_e, g_e = band_inputs()
        g_e = g_e * mask[:, None, :, None]          # the LM's masked loss: dO = 0 on padding
        valid = mask[:, None, :, None] > 0
        ok, gk = fwd_bwd(e_kernel(mask), (q_e, k_e, v_e), g_e)
        op, gp = fwd_bwd(e_plain(mask), (q_e, k_e, v_e), g_e)
        with torch.no_grad():
            lse_k = twk.forward_kernel(q_e, k_e, v_e, mask, WIN)[1].sum(0)
            _, lse_p = twk.window_attention_band_plain(q_e, k_e, v_e, mask, WIN)
        finite = all(bool(torch.isfinite(t).all()) for t in (ok, lse_k, *gk))
        e_valid, e_all = max_err(ok * valid, op * valid), max_err(ok, op)
        l_valid = max_err(lse_k * valid[..., 0], lse_p * valid[..., 0])
        if tag == "synthetic padding":
            e_err = e_valid
        print(f"[window_attn] B={BD} H={HD} S={SD} D={ED} window {WIN}, {tag}: max|d out| "
              f"{e_valid:.3e} on kept rows, {e_all:.3e} on all rows (max|out| "
              f"{magnitude(op):.3e}); max|d lse| {l_valid:.3e} on kept rows; all finite: "
              f"{finite}", flush=True)
        check(finite, f"window_attn {tag}: a value or gradient of the kernel is not finite")
        check(e_all <= 1e-5 * magnitude(op), f"window_attn {tag} forward: max|diff| {e_all}")
        check(l_valid <= 1e-5 * magnitude(lse_p), f"window_attn {tag} lse: max|diff| {l_valid}")
        for name, x, y in zip(("dq", "dk", "dv"), gk, gp):
            e = max_err(x, y)
            print(f"[window_attn] {tag} {name}: max|diff| {e:.3e} of magnitude "
                  f"{magnitude(y):.3e}", flush=True)
            check(e <= 1e-4 * magnitude(y), f"window_attn {tag} {name}: max|diff| {e}")
        if tag == "synthetic padding":
            # the control: the twin on q, k, v rounded to bf16, against the
            # f32 twin, must end above the gates the kernel is held below
            oc, gc = fwd_bwd(e_plain(mask), [t.bfloat16().float() for t in (q_e, k_e, v_e)],
                             g_e)
            e_ctl = {"out": max_err(oc, op) / magnitude(op)}
            e_ctl.update({n_: max_err(x, y) / magnitude(y)
                          for n_, x, y in zip(("dq", "dk", "dv"), gc, gp)})
            e_share = {"out": e_all / magnitude(op)}
            e_share.update({n_: max_err(x, y) / magnitude(y)
                            for n_, x, y in zip(("dq", "dk", "dv"), gk, gp)})
            print(f"[window_attn] control, the twin on q, k, v rounded to bfloat16 against the "
                  f"f32 twin, share of magnitude: " + ", ".join(
                      f"{k_} {v_:.3e} (kernel {e_share[k_]:.3e})" for k_, v_ in e_ctl.items())
                  + "; gates out 1e-5, gradients 1e-4", flush=True)
            check(e_ctl["out"] > 1e-5 and all(e_ctl[n_] > 1e-4 for n_ in ("dq", "dk", "dv")),
                  f"window_attn: the gates would pass bf16-rounded inputs ({e_ctl})")
            del oc, gc
        del ok, gk, op, gp
    # bf16 tensors: E against its twin of JAX's bf16 arithmetic (f32 scores,
    # softmax and products, out and the gradients rounded on store, dr from
    # the rounded out), the synthetic padding; every tensor within
    # E_BF16_GATES, the control (P and dS rounded before their products)
    # above the mean limits
    e16_in = as_bf16(band_inputs())
    g16 = e16_in[3] * dms[:, None, :, None].bfloat16()
    e_read16, e16_out = band_bf16_readings(twk, *e16_in[:3], dms, WIN, g16)
    # the exact gate: E's bf16 out and gradients equal, bit for bit, its
    # f32 route on the widened operands (the stored bf16 out handed to the
    # backward), rounded to bf16; the control (P and dS rounded, what a
    # dropped plane of an f32 operand computes) must differ
    e_exact = band_exact_readings(twk, twk.forward_kernel, twk.backward_kernel, *e16_in[:3], dms,
                                  WIN, g16, e16_out)
    print("[window_attn] bf16 against the f32 route rounded, differing elements: " + ", ".join(
        f"{n} {r['kernel']} of {t.numel()} (control {r['control']})"
        for (n, r), t in zip(e_exact.items(), e16_out)), flush=True)
    for msg in exact_gate_failures(e_exact):
        fail(f"window_attn bf16 exact gate {msg}")
    for name, r in e_read16.items():
        print(f"[window_attn] bf16 {name}: max / mean share {r['kernel'][0]:.3e} / "
              f"{r['kernel'][1]:.3e} (gate {E_BF16_GATES[name][0]:.3e} / "
              f"{E_BF16_GATES[name][1]:.3e}); the P / dS rounded control {r['control'][0]:.3e} / "
              f"{r['control'][1]:.3e}", flush=True)
    for msg in bf16_gate_failures(e_read16, E_BF16_GATES,
                                  {"control": "the P / dS rounded control"}):
        fail(f"window_attn bf16 {msg}")
    e_err16 = e_read16["out"]["max_abs"]
    del e16_in, e16_out
    # the library yardstick: one PyTorch call with the (B, 1, S, S) additive mask
    q_e, k_e, v_e, g_e = band_inputs()
    g_e = g_e * dms[:, None, :, None]
    lib_mask = torch.where(band[None, None] & (dms[:, None, None, :] > 0), 0.0, -1e9)
    e_lib = lambda q_, k_, v_: torch.nn.functional.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=lib_mask)
    valid = dms[:, None, :, None] > 0
    with torch.no_grad():
        o_lib, o_pl = e_lib(q_e, k_e, v_e), e_plain(dms)(q_e, k_e, v_e)
    lib_err = max_err(o_lib * valid, o_pl * valid)
    print(f"[window_attn] scaled_dot_product_attention with the additive band mask "
          f"({lib_mask.numel() * 4 / 1e6:.0f} MB): max|diff| {lib_err:.3e} from the plain twin "
          f"on kept rows", flush=True)
    check(lib_err <= 1e-4 * magnitude(o_pl), f"library window attention: max|diff| {lib_err}")
    del o_lib, o_pl

    # -- 8. kernel D at the Longformer's shape (mid_drop=False) -------------
    dp0 = lf.init_params(dcfg, seed=0, device=dev)
    lf_ws = tail_weights({k: {kk: vv[0] for kk, vv in v.items()}
                          for k, v in dp0["layers"].items()})
    h_lf, a_lf, g_lf = (torch.randn((ND, dcfg.d_model), generator=gen, device=dev)
                        for _ in range(3))
    d_lf_in = (h_lf, a_lf, *lf_ws)
    d_lf_err = check_tail(f"attn_tail N={ND} D={dcfg.d_model} DI={dcfg.d_inner} mid_drop=False",
                          tfb, d_lf_in, g_lf, seed_t, False)
    d_lf_err_bf16 = check_tail(f"attn_tail N={ND} D={dcfg.d_model} DI={dcfg.d_inner} "
                               f"mid_drop=False bf16", tfb, as_bf16(d_lf_in), g_lf.bfloat16(),
                               seed_t, False, (BF16_TOL, BF16_TOL))

    # -- 9. one discriminator-LM step on three routes ------------------------
    droutes = {"default": {}, "window": {"RLMG_WINDOW_BACKEND": "pallas"},
               "plain": {"RLMG_FFN_BACKEND": "xla"}}
    dwant = {"default": [0, 0, 12, 12] + [0] * 6, "window": [0] * 4 + [12, 12] + [0] * 4,
             "plain": [0] * 10}
    dstep_out, dstep_ms = {}, {}
    for name in ("default", "window", "plain"):
        dstep_out[name], counts, dstep_ms[name] = route_step(
            droutes[name], dp0, dcfg, (dxs.long(), dys.long(), dms), tpre.longformer_grad_step,
            tpre.longformer_lm_step)
        print(f"[discrim_step] {name} route: loss {dstep_out[name][0]:.6f}, kernel launches "
              f"(C, D, E, F, G fwd/bwd) {counts}, {dstep_ms[name]:.1f} ms/step, "
              f"{ND / dstep_ms[name] * 1e3:.1f} tokens/s", flush=True)
        check(counts == dwant[name],
              f"discrim step, {name} route: launches {counts}, expected {dwant[name]}")
        torch.cuda.empty_cache()
    # bf16 parameters under RLMG_WINDOW_BACKEND=pallas: kernel E on bf16
    # tensors in every layer, forward and backward
    set_env(droutes["window"])
    dp16 = lt.cast_params(dp0, bf16)
    zero_counts()
    grads16, (loss16, _) = tpre.longformer_grad_step(dp16, dcfg, dxs.long(), dys.long(), dms,
                                                     None)
    torch.cuda.synchronize()
    counts = read_counts()
    restore_env()
    finite16 = all(bool(torch.isfinite(g_.float()).all()) for g_ in named_leaves(grads16).values())
    print(f"[discrim_step] window route, bf16 parameters: loss {float(loss16):.6f}, gradients "
          f"finite: {finite16}; launches (C, D, E, F, G fwd/bwd) {counts}", flush=True)
    check(math.isfinite(float(loss16)) and finite16,
          "discrim step, bf16 parameters: a loss or gradient is not finite")
    check(counts == dwant["window"], f"discrim step, bf16 parameters: launches {counts}, "
                                     f"expected {dwant['window']}")
    launches["E_bf16"] = counts[4:6]
    del dp16, grads16
    for name in ("default", "window"):
        check_step(f"discrim_step {name}", dstep_out[name], dstep_out["plain"],
                   zero_grads=("/layers/wk/b",))
    del dstep_out, dp0

    # -- 10. the discriminator main path: cli discrim-pretrain, 4 steps -----
    dcli = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("default", "window"):
            set_env(droutes[name])
            zero_counts()
            res = cli.main(["discrim-pretrain", "--seq-len", str(SD), "--batch-size", str(BD),
                            "--synthetic-songs", "8", "--max-steps", "4",
                            "--exp-dir", os.path.join(tmp, name, "exp"),
                            "--ckpt-dir", os.path.join(tmp, name, "ckpt")])
            torch.cuda.synchronize()
            counts = read_counts()
            dcli[name] = (res, counts)
            ms_step = res["seconds"] / res["steps"] * 1e3
            print(f"[discrim-pretrain] {name} route: {res['steps']} steps in "
                  f"{res['seconds']:.3f}s = {ms_step:.1f} ms/step, {res['tokens_per_s']:.1f} "
                  f"tokens/s (with one epoch-end checkpoint); logged losses "
                  f"{res['batch_losses']}; launches (C, D, E, F, G fwd/bwd) {counts}", flush=True)
            check(res["steps"] == 4, f"discrim-pretrain {name}: {res['steps']} steps")
            check(len(res["batch_losses"]) > 0 and all(
                math.isfinite(v) for v in res["batch_losses"] + res["history"]),
                f"discrim-pretrain {name}: a logged loss is not finite")
            want = [4 * c for c in dwant[name]]
            check(counts == want, f"discrim-pretrain {name}: launches {counts}, expected {want}")
    restore_env()
    launches["E"] = dcli["window"][1][4:6]
    launches["D_discrim"] = dcli["default"][1][2:4]

    # -- 11. kernel F against its plain twin -------------------------------
    def product_inputs(b, h, s_, e):
        """phi(q), phi(k) (elu+1 of normals), v and dO (B, H, S, E), as the
        model passes them: (B, H, S, E) views of (B, S, H, E) tensors."""
        t = [torch.randn((b, s_, h, e), generator=gen, device=dev).transpose(1, 2)
             for _ in range(4)]
        return tla.feature_map(t[0]), tla.feature_map(t[1]), t[2], t[3]

    f_kernel = lambda *a: tlk.causal_product(*a, cfg.attn_eps)[0]
    f_plain = lambda *a: tlk.causal_product_plain(*a, cfg.attn_eps)[0]
    BQ, SQ = 30, 50                               # a DQN update's (B, S)
    f_shapes = {"rollout": (1, H, SQ, E), "dqn": (BQ, H, SQ, E), "pretrain": (BT, H, ST, E),
                "ragged": (4, H, 300, E), "edge64": (4, H, 64, E), "edge65": (4, H, 65, E)}
    f_in, f_err = {}, {}
    tlk.kernel_runs(reset=True)
    f_calls = (tlk.causal_product.launches_fwd, tlk.causal_product.launches_bwd)
    for tag, shape in f_shapes.items():
        pq, pk, v_f, g_f = f_in[tag] = product_inputs(*shape)
        ok, gk = fwd_bwd(f_kernel, (pq, pk, v_f), g_f)
        op, gp = fwd_bwd(f_plain, (pq, pk, v_f), g_f)
        with torch.no_grad():
            den_k = tlk.causal_product(pq, pk, v_f, cfg.attn_eps)[1]
            den_p = tlk.causal_product_plain(pq, pk, v_f, cfg.attn_eps)[1]
        f_err[tag] = e_out = max_err(ok, op)
        e_den = max_err(den_k, den_p)
        print(f"[causal_product] {tag} {tuple(shape)}: max|d out| {e_out:.3e} (max|out| "
              f"{magnitude(op):.3e}), max|d den| {e_den:.3e} (max|den| {magnitude(den_p):.3e})",
              flush=True)
        check(e_out <= 1e-4 * magnitude(op), f"causal_product {tag} out: max|diff| {e_out}")
        check(e_den <= 1e-4 * magnitude(den_p), f"causal_product {tag} den: max|diff| {e_den}")
        for name, x_, y_ in zip(("dq", "dk", "dv"), gk, gp):
            e_ = max_err(x_, y_)
            print(f"[causal_product] {tag} {name}: max|diff| {e_:.3e} of magnitude "
                  f"{magnitude(y_):.3e}", flush=True)
            check(bool(torch.isfinite(x_).all()), f"causal_product {tag} {name}: not finite")
            check(e_ <= 1e-3 * magnitude(y_), f"causal_product {tag} {name}: max|diff| {e_}")
        del ok, gk, op, gp
    f_calls = (tlk.causal_product.launches_fwd - f_calls[0],
               tlk.causal_product.launches_bwd - f_calls[1])
    f_runs = tlk.kernel_runs()
    print(f"[causal_product] runs as the kernel counts them {f_runs}, the wrapper's calls "
          f"{f_calls}", flush=True)
    check(f_runs == f_calls, f"causal_product: the kernel counted {f_runs} runs for the "
          f"wrapper's {f_calls} calls")
    for tag in ("dqn", "ragged", "pretrain"):               # one tile, and the state pass
        pq, pk, v_f, g_f = f_in[tag]
        out_f, den_f = tlk.forward_kernel(pq, pk, v_f, cfg.attn_eps)
        g1 = tlk.backward_kernel(pq, pk, v_f, out_f, den_f, g_f, cfg.attn_eps)
        g2 = tlk.backward_kernel(pq, pk, v_f, out_f, den_f, g_f, cfg.attn_eps)
        same = all(torch.equal(a_, b_) for a_, b_ in zip(g1, g2))
        print(f"[causal_product] {tag}: two backward runs {'bit-equal' if same else 'DIFFERENT'}",
              flush=True)
        check(same, f"causal_product {tag}: two backward runs differ")
    # bf16 tensors in the model's layout: F against its twin of JAX's bf16
    # arithmetic (f32 products, out and den rounded on store, dnum / dd in
    # bf16 arithmetic from them) at the rollout, ragged and pretrain shapes:
    # every tensor within F_BF16_GATES, the bf16 composition above every mean
    # limit and F's f32 route (den unrounded) above the gradients'; two
    # backward runs bit-equal
    f_read16 = {}
    for tag in ("rollout", "ragged", "pretrain"):
        pq, pk, v_f, g_f = as_bf16(f_in[tag])
        f_read16[tag], _ = product_bf16_readings(tlk, tla, pq, pk, v_f, g_f, cfg.attn_eps,
                                                 CHUNK)
        for name, r in f_read16[tag].items():
            f32r = (f"; F's f32 route {r['control_f32_route'][0]:.3e} / "
                    f"{r['control_f32_route'][1]:.3e}" if "control_f32_route" in r else "")
            print(f"[causal_product] bf16 {tag} {name}: max / mean share {r['kernel'][0]:.3e} / "
                  f"{r['kernel'][1]:.3e} (gate {F_BF16_GATES[name][0]:.3e} / "
                  f"{F_BF16_GATES[name][1]:.3e}); the bf16 composition {r['control'][0]:.3e} / "
                  f"{r['control'][1]:.3e}{f32r}", flush=True)
        for msg in bf16_gate_failures(f_read16[tag], F_BF16_GATES,
                                      {"control": "the bf16 composition",
                                       "control_f32_route": "F's f32 route"}):
            fail(f"causal_product bf16 {tag} {msg}")
        # the exact gate: F's bf16 out and den equal, bit for bit, its f32
        # route on the widened inputs, rounded; the control (A and the
        # state rounded: a dropped plane of each) must differ
        with torch.no_grad():
            got16 = tlk.forward_kernel(pq, pk, v_f, cfg.attn_eps)
        f_exact = product_exact_readings(tlk.forward_kernel, pq, pk, v_f, cfg.attn_eps, got16,
                                         CHUNK)
        print(f"[causal_product] bf16 {tag} against the f32 route rounded, differing elements: "
              + ", ".join(f"{n} {r['kernel']} of {t.numel()} (control {r['control']})"
                          for (n, r), t in zip(f_exact.items(), got16)), flush=True)
        for msg in exact_gate_failures(f_exact):
            fail(f"causal_product bf16 {tag} exact gate {msg}")
        out_f, den_f = tlk.forward_kernel(pq, pk, v_f, cfg.attn_eps)
        g1 = tlk.backward_kernel(pq, pk, v_f, out_f, den_f, g_f, cfg.attn_eps)
        g2 = tlk.backward_kernel(pq, pk, v_f, out_f, den_f, g_f, cfg.attn_eps)
        same = all(torch.equal(a_, b_) for a_, b_ in zip(g1, g2))
        print(f"[causal_product] bf16 {tag}: two backward runs "
              f"{'bit-equal' if same else 'DIFFERENT'}", flush=True)
        check(same, f"causal_product bf16 {tag}: two backward runs differ")
    pq, pk, v_f, g_f = f_in["ragged"]
    for what, bad in (("float64", (pq.double(), pk.double(), v_f.double())),
                      ("head width 72", (torch.ones((1, H, SQ, 72), device=dev),) * 3)):
        try:
            tlk.causal_product(*bad)
        except (TypeError, ValueError) as e:
            print(f"[causal_product] {what}: refused ({e})", flush=True)
        else:
            fail(f"causal_product took {what}")

    # -- 12. one full-width DQN update on the default and the kernel-F route -
    from reinforcement_learning_in_music_generation_torch.rl import airl, buffers, dqn, env
    from reinforcement_learning_in_music_generation_torch.rl import episode_graph as teg
    vocab = (56, 135, 18, 87, 18, 25)             # dqn-train's six fields
    qcfg = C.agent_config(vocab, dropout=0.0)
    # lr 1e-4, as phase 5 steps, so the parameter check can see an update
    # (DQNConfig's 0.01 would move every parameter by 0.01 on a gradient's sign)
    dqcfg = C.DQNConfig(lr=1e-4)
    qxs, qys, qms = (torch.from_numpy(a).to(dev) for a in
                     dataset.synthetic_cp_dataset(BQ, 512, n_class=vocab, seed=0))
    qp0 = lt.init_params(qcfg, seed=0, device=dev)
    rollout_states = qxs[:, 100:100 + SQ].contiguous()
    qbatch = {"state": rollout_states.int(),
              "action": qys[:, 200:200 + dqcfg.n_actions].int(),
              "reward": torch.rand((BQ, 1), generator=gen, device=dev),
              "next_state": torch.cat([rollout_states[:, :dqcfg.n_actions],
                                       qys[:, 200:200 + dqcfg.n_actions]], 1).int(),
              "done": torch.zeros((BQ, 1), dtype=torch.int32, device=dev)}
    qebatch = {"state": qys[:, :SQ].int(), "next_state": qys[:, SQ:2 * SQ].int(),
               "mask_next_state": qms[:, 1:SQ + 1].float()}
    act_states = torch.from_numpy(dataset.synthetic_cp_dataset(SQ, SQ, n_class=vocab,
                                                               seed=3)[0]).to(dev)
    qroutes = {"default": {}, "kernel": {"RLMG_ATTN_BACKEND": "pallas"}}
    q_out, q_ms, q_act = {}, {}, {}
    for name, envv in qroutes.items():
        set_env(envv)
        qs = dqn.init_state(qcfg, dqcfg, topt.tree_map(torch.clone, qp0))
        qtx = dqn.make_optimizer(dqcfg)
        zero_counts()
        qs, qm = dqn.update(qs, qcfg, dqcfg, qtx, qbatch, qebatch, None)
        torch.cuda.synchronize()
        counts = read_counts()
        after = named_leaves(qs.eval_params)
        # the step's gradient from Adam's first moment ((1 - b1) g after one
        # step), and its update recomputed from it (a first step from zeros)
        g_tree = topt.tree_map(lambda m_: m_ / (1.0 - qtx.b1), qs.opt_state.mu)
        u_tree, _ = qtx.update(g_tree, qtx.init(g_tree))
        q_out[name] = (float(qm["total"]), torch.stack([qm["mse"], qm["ce"]]).cpu(), after,
                       named_leaves(g_tree), named_leaves(u_tree))
        del g_tree, u_tree
        print(f"[dqn_update] {name} route: mse {float(qm['mse']):.7f}, ce {float(qm['ce']):.7f}"
              f", total {float(qm['total']):.7f}; launches (C, D, E, F, G fwd/bwd) {counts}",
              flush=True)
        want = [0] * 6 + ([3 * L, 2 * L] if name == "kernel" else [0, 0]) + [0, 0]
        check(counts == want, f"dqn update, {name} route: launches {counts}, expected {want}")
        t = time.perf_counter()
        for _ in range(2):
            qs, _ = dqn.update(qs, qcfg, dqcfg, qtx, qbatch, qebatch, None)
        torch.cuda.synchronize()
        q_ms[name] = (time.perf_counter() - t) / 2 * 1e3
        q_act[name] = dqn.choose_action(qp0, qcfg, act_states)
        del qs, qtx
    restore_env()
    rel = (q_out["kernel"][1] - q_out["default"][1]).abs() / q_out["default"][1].abs()
    print(f"[dqn_update] mse / ce relative differences {rel.tolist()}; {q_ms['default']:.1f} ms "
          f"per update (default), {q_ms['kernel']:.1f} ms (kernel F)", flush=True)
    check(bool((rel <= 1e-4).all()), f"dqn update: mse / ce differ by {rel.tolist()}")
    check_step("dqn_update", q_out["kernel"], q_out["default"])
    agree = (q_act["kernel"] == q_act["default"]).float().mean().item()
    print(f"[dqn_update] choose_action on {SQ} states: {agree:.4%} of action fields equal "
          f"across routes", flush=True)
    check(agree >= 0.99, f"choose_action: {agree} < 99% equal across routes")

    # -- 12b. the DQN rollout: a graph replay an episode against the eager loop
    q_roll = {}
    for name, envv in qroutes.items():
        set_env(envv)
        hold = {"s": dqn.init_state(qcfg, dqcfg, topt.tree_map(torch.clone, qp0))}
        qtx = dqn.make_optimizer(dqcfg)

        def q_rollout(i, graph):
            return env.dqn_rollout_song(hold["s"].eval_params, qcfg, qxs[i], qys[i], qms[i],
                                        episodes=50, n_states=SQ, n_actions=dqcfg.n_actions,
                                        graph=graph)[0]

        def q_update():
            hold["s"], _ = dqn.update(hold["s"], qcfg, dqcfg, qtx, qbatch, qebatch, None)

        zero_counts()
        tlk.kernel_runs(reset=True)
        caps = teg.EpisodeLoop.captures
        q_roll[name] = compare_rollouts(f"dqn_rollout {name}", q_rollout, 4, q_update,
                                        ("state", "action", "next_state"), ())
        torch.cuda.synchronize()
        counts, runs = read_counts(), tlk.kernel_runs()
        caps = teg.EpisodeLoop.captures - caps
        # 6 songs each way (4, one after the update, one window); the wrappers
        # count the eager episodes only, each capture's first one among them;
        # F counts its own runs, replays included
        eager = 6 * 50 + caps
        on = name == "kernel"
        want = [0] * 6 + ([eager * L + 3 * L, 2 * L] if on else [0, 0]) + [0, 0]
        want_runs = (12 * 50 * L + 3 * L, 2 * L) if on else (0, 0)
        print(f"[dqn_rollout] {name} route: {caps} capture(s); the wrappers' eager launches "
              f"(C, D, E, F, G fwd/bwd) {counts}; F's runs as the kernel counts them {runs}",
              flush=True)
        check(caps == 1, f"dqn rollouts, {name} route: {caps} captures, expected 1")
        check(counts == want, f"dqn rollouts, {name} route: launches {counts}, expected {want}")
        check(runs == want_runs, f"dqn rollouts, {name} route: F counted {runs} runs, "
              f"expected {want_runs}")
        del hold, qtx
    restore_env()
    del q_out, qp0

    # -- 13. one AIRL discriminator step and a scoring pass at full width ------
    wcfg = C.airl_discriminator_config(vocab, n_layer=10)
    acfg = C.AIRLConfig()
    NA = acfg.batch_size                          # 100 states of S = 50
    rst = airl.init_state(wcfg, acfg, seed=1, device=dev)
    rtx = airl.make_optimizer(acfg)
    a_states = torch.from_numpy(dataset.synthetic_cp_dataset(500, SQ, n_class=vocab,
                                                             seed=1)[0]).to(dev).int()
    e_states = torch.from_numpy(dataset.synthetic_cp_dataset(500, SQ, n_class=vocab,
                                                             seed=2)[0]).to(dev).int()
    e_masks = (torch.rand((500, SQ), generator=gen, device=dev) > 0.05).float()
    zero_counts()
    rst, rm = airl.disc_step(rst, wcfg, rtx, e_states[:NA], e_masks[:NA], a_states[:NA], gen)
    scores = airl.calculate_reward(rst, wcfg, a_states, e_masks, acfg.score_batch_size)
    torch.cuda.synchronize()
    check(read_counts() == [0] * 10, f"AIRL step: launches {read_counts()}, expected none "
          "(5000 rows take the plain route)")
    rvals = {k: float(v) for k, v in rm.items()}
    print(f"[airl] disc_step B={NA} S={SQ}, 10 layers: {rvals}; scores of 500 states in "
          f"[{scores.min().item():.4f}, {scores.max().item():.4f}]", flush=True)
    check(all(math.isfinite(v) for v in rvals.values()), "AIRL disc_step: a loss is not finite")
    check(scores.shape == (500, 1) and bool(torch.isfinite(scores).all()),
          "AIRL calculate_reward: scores not finite or of the wrong shape")
    t = time.perf_counter()
    for i in range(3):
        rst, _ = airl.disc_step(rst, wcfg, rtx, e_states[NA * i:NA * (i + 1)],
                                e_masks[NA * i:NA * (i + 1)], a_states[NA * i:NA * (i + 1)], gen)
    torch.cuda.synchronize()
    airl_step_ms = (time.perf_counter() - t) / 3 * 1e3
    t = time.perf_counter()
    airl.calculate_reward(rst, wcfg, a_states, e_masks, acfg.score_batch_size)
    torch.cuda.synchronize()
    airl_score_ms = (time.perf_counter() - t) * 1e3
    print(f"[time] AIRL disc_step B={NA} x S={SQ}: {airl_step_ms:.1f} ms; scoring 500 states: "
          f"{airl_score_ms:.1f} ms", flush=True)
    del rst, rtx

    # -- 14. the slice's main path: cli dqn-train on both routes ---------------
    qcli = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, envv in qroutes.items():
            set_env(envv)
            ck = os.path.join(tmp, name, "ckpt")
            zero_counts()
            tlk.kernel_runs(reset=True)
            caps = teg.EpisodeLoop.captures
            res = cli.main(["dqn-train", "--synthetic", "--synthetic-songs", "16",
                            "--seq-len", "512", "--batch-size", str(BQ), "--buffer-size", "500",
                            "--songs", "12", "--max-updates", "2", "--ckpt-epoch-gate", "0",
                            "--exp-dir", os.path.join(tmp, name, "exp"), "--ckpt-dir", ck])
            torch.cuda.synchronize()
            counts = read_counts()
            caps = teg.EpisodeLoop.captures - caps
            qcli[name] = (res, counts, tlk.kernel_runs())
            med = lambda v: sorted(v)[len(v) // 2]
            print(f"[dqn-train] {name} route: {res['updates']} updates; ms per rollout song "
                  f"(50 episodes) median {med(res['rollout_ms']):.1f} (first "
                  f"{res['rollout_ms'][0]:.1f}); ms per DQN update {res['update_ms']}; ms per "
                  f"AIRL pass {res['airl_ms']} (the first trains, the second scores); launches "
                  f"(C, D, E, F, G fwd/bwd) {counts}", flush=True)
            check(res["updates"] == 2, f"dqn-train {name}: {res['updates']} updates, expected 2")
            for f_ in ("dqn_last.ckpt", "dqn_best.ckpt", "agent_info.pickle"):
                check(os.path.exists(os.path.join(ck, f_)), f"dqn-train {name}: no {f_}")
            check(all(math.isfinite(v) for m_ in res["metrics"] for v in m_.values()),
                  f"dqn-train {name}: a printed loss or score is not finite")
            # F runs 12 songs x 50 episodes x 12 layers and 3 forwards and 2
            # backwards of the 12 layers an update, as the kernel counts them;
            # the wrapper counts the eager calls: each capture's first episode
            # and the updates
            on = name == "kernel"
            want_runs = (12 * (50 * 12 + 3 * 2), 12 * 2 * 2) if on else (0, 0)
            want = [0] * 6 + ([12 * (caps + 3 * 2), 12 * 2 * 2] if on else [0, 0]) + [0, 0]
            check(caps >= 1, f"dqn-train {name}: the rollouts captured no graph")
            check(counts == want, f"dqn-train {name}: launches {counts}, expected {want}")
            runs = tlk.kernel_runs()
            check(runs == want_runs, f"dqn-train {name}: F counted {runs} runs, expected "
                  f"{want_runs}")
            cli_med = med(res["rollout_ms"][1:])
            ratio = cli_med / q_roll[name]["median_eager"]
            print(f"[dqn-train] {name} route: {caps} capture(s); F's runs as the kernel counts "
                  f"them {runs}; median "
                  f"ms per rollout song after the first {cli_med:.1f} (graph replays) against "
                  f"the eager loop's {q_roll[name]['median_eager']:.1f} (phase 12b): "
                  f"{ratio:.3f}", flush=True)
            check(ratio <= 1 / 3, f"dqn-train {name}: graphed rollout songs take {ratio:.3f} "
                  "of the eager loop's time, more than a third")
    restore_env()
    launches["F"] = qcli["kernel"][2]                 # the kernel's own count
    launches["F_eager"] = qcli["kernel"][1][6:8]

    # -- 15. cli pretrain on kernel F's route (RLMG_ATTN_BACKEND=pallas) -----
    with tempfile.TemporaryDirectory() as tmp:
        set_env({"RLMG_ATTN_BACKEND": "pallas"})
        zero_counts()
        tlk.kernel_runs(reset=True)
        res = cli.main(["pretrain", "--synthetic", "--synthetic-songs", "64", "--batch-size",
                        str(BT), "--seq-len", str(ST), "--max-steps", "4",
                        "--exp-dir", os.path.join(tmp, "exp"), "--ckpt-dir",
                        os.path.join(tmp, "ckpt")])
        torch.cuda.synchronize()
        counts = read_counts()
    restore_env()
    ms_step = res["seconds"] / res["steps"] * 1e3
    print(f"[pretrain] kernel-F route: {res['steps']} steps in {res['seconds']:.3f}s = "
          f"{ms_step:.1f} ms/step, {res['tokens_per_s']:.1f} tokens/s; logged losses "
          f"{res['batch_losses']}; launches (C, D, E, F, G fwd/bwd) {counts}", flush=True)
    check(res["steps"] == 4, f"pretrain on kernel F's route: {res['steps']} steps")
    check(len(res["batch_losses"]) > 0 and all(
        math.isfinite(v) for v in res["batch_losses"] + res["history"]),
        "pretrain on kernel F's route: a logged loss is not finite")
    want = [0] * 6 + [12 * 4, 12 * 4, 0, 0]
    check(counts == want, f"pretrain on kernel F's route: launches {counts}, expected {want}")
    runs = tlk.kernel_runs()
    check(list(runs) == want[6:8], f"pretrain on kernel F's route: F counted {runs} runs")
    launches["F_pretrain"] = counts[6:8]

    # -- 16. kernel G against its plain twin ----------------------------------
    ffn_ws = [t.contiguous() for t in (lp0["ffn1"]["w"], lp0["ffn1"]["b"], lp0["ffn2"]["w"],
                                       lp0["ffn2"]["b"], lp0["ln2"]["scale"],
                                       lp0["ln2"]["bias"])]
    SE, NE, NS, NA_ = 30, 50, 25, 6                # PPO: episodes, states, actions, fields
    g_rows = {"rollout": NE, "ragged": 2 * NE, "update": SE * NE, "pretrain": NT}
    g_in, g_err = {}, {}
    for tag, n in g_rows.items():
        g_in[tag] = ((h_tr, g_tr) if n == NT else
                     (torch.randn((n, D), generator=gen, device=dev),
                      torch.randn((n, D), generator=gen, device=dev)))
        h_g, gg = g_in[tag]
        g_kernel = lambda p: (lambda *a: tfb.ffn_block(*a, seed_t, p))
        g_plain = lambda p: (lambda *a: tfb.ffn_block_plain(*a, seed_t, p))
        g_err[tag] = check_fused(f"ffn_block {tag} N={n} D={D} DI={DI}", g_kernel, g_plain,
                                 (h_g, *ffn_ws), gg, FFN_GRADS)
        # bf16 tensors against the twin of JAX's bf16 arithmetic
        g_err[tag, "bf16"] = check_fused(f"ffn_block {tag} N={n} D={D} DI={DI} bf16", g_kernel,
                                         g_plain, as_bf16((h_g, *ffn_ws)), gg.bfloat16(),
                                         FFN_GRADS, (BF16_TOL, BF16_TOL))
    for tag in ("ragged", "update"):
        for dt in (torch.float32, torch.bfloat16):
            h_g, gg = (t.to(dt) for t in g_in[tag])
            ws_ = [w.to(dt) for w in ffn_ws]
            g1 = tfb.ffn_backward_kernel(h_g, ws_, gg, seed_t, 0.1)
            g2 = tfb.ffn_backward_kernel(h_g, ws_, gg, seed_t, 0.1)
            same = all(torch.equal(a_, b_) for a_, b_ in zip(g1, g2))
            print(f"[ffn_block] {tag} {str(dt)[6:]}: two backward runs "
                  f"{'bit-equal' if same else 'DIFFERENT'}", flush=True)
            check(same, f"ffn_block {tag} {dt}: two backward runs differ")
    wide = [torch.ones(s_, device=dev) for s_ in ((1028, 64), (64,), (64, 1028), (1028,),
                                                  (1028,), (1028,))]
    try:
        tfb.ffn_block(torch.ones((8, 1028), device=dev), *wide, 0, 0.0)
    except ValueError as e:
        print(f"[ffn_block] d_model 1028: refused ({e})", flush=True)
    else:
        fail("ffn_block took d_model 1028")

    # -- 17. one full-width PPO update on the default and the kernel-G route --
    from reinforcement_learning_in_music_generation_torch.models import critic as critic_lib
    from reinforcement_learning_in_music_generation_torch.rl import ppo
    avocab = (49, 19, 19, 89, 67, 25)             # ppo-train's tuple-event fields
    pacfg, pccfg = C.actor_config(avocab, dropout=0.0), C.critic_config(avocab, dropout=0.0)
    prcfg = C.ppo_reward_config(avocab, n_layer=10, dropout=0.0)
    pcfgs = (pacfg, pccfg, prcfg)
    # lr 1e-4 as phases 5 and 12 (PPOConfig's 0.01 moves a parameter by
    # 0.01 on a gradient's sign, which the parameter check cannot see past)
    ppcfg = C.PPOConfig(lr=1e-4)
    pst0 = ppo.init_state(pacfg, pccfg, prcfg, ppcfg, seed=0, device=dev)
    px, py, pm = (torch.from_numpy(a).to(dev) for a in
                  dataset.synthetic_cp_dataset(1, 512, n_class=avocab, seed=5))
    p_states = torch.from_numpy(dataset.synthetic_cp_dataset(NE, NE, n_class=avocab,
                                                             seed=3)[0]).to(dev)
    proutes = {"default": {}, "kernel": {"RLMG_FFN_BACKEND": "pallas"}}

    def ppo_fresh():
        """A PPOState with copies of pst0's actor and critic (the optimizer
        adds in place) and new Adam states."""
        a_ = topt.tree_map(torch.clone, pst0.actor_params)
        c_ = topt.tree_map(torch.clone, pst0.critic_params)
        txs_ = ppo.make_optimizers(ppcfg)
        return ppo.PPOState(a_, c_, pst0.reward_params, txs_[0].init(a_), txs_[1].init(c_)), txs_

    p_roll, p_act = {}, {}
    for name, envv in proutes.items():
        set_env(envv)
        pst, _ = ppo_fresh()
        zero_counts()
        tfb.ffn_kernel_runs(reset=True)
        caps = teg.EpisodeLoop.captures
        p_roll[name] = ppo.rollout_song(pst, pcfgs, px[0], py[0], pm[0], episodes=SE,
                                        n_states=NE, n_actions=NS)
        torch.cuda.synchronize()
        counts, g_runs = read_counts(), tfb.ffn_kernel_runs()
        caps = teg.EpisodeLoop.captures - caps
        # a graphed song: the wrapper counts the capture's first episode, G
        # its own runs of every episode
        per_ep = pacfg.n_layer + pccfg.n_layer
        on = name == "kernel"
        want = [0] * 8 + ([caps * per_ep, 0] if on else [0, 0])
        want_runs = SE * per_ep if on else 0
        print(f"[ppo_rollout] {name} route: {caps} capture(s); the wrappers' eager launches "
              f"(C, D, E, F, G fwd/bwd) {counts}; G's forward runs as the kernel counts them "
              f"{g_runs}", flush=True)
        check(caps == 1, f"ppo rollout, {name} route: {caps} captures, expected 1")
        check(counts == want, f"ppo rollout, {name} route: launches {counts}, expected {want}")
        check(g_runs == want_runs, f"ppo rollout, {name} route: G counted {g_runs} runs, "
              f"expected {want_runs}")
        p_act[name] = ppo.choose_action(pst0.actor_params, pacfg, p_states, n_actions=NS)[0]
    restore_env()
    agree = (p_act["kernel"] == p_act["default"]).float().mean().item()
    r_agree = (p_roll["kernel"][0]["action"] == p_roll["default"][0]["action"]).float().mean()
    print(f"[ppo_update] choose_action on {NE} states: {agree:.4%} of action fields equal "
          f"across routes; the rollouts' actions {r_agree.item():.4%}", flush=True)
    check(agree >= 0.99, f"ppo choose_action: {agree} < 99% equal across routes")
    agent_d, expert_d = p_roll["default"]
    agent_k = p_roll["kernel"][0]
    # the kernel route's critic on the default route's states (a near-tie
    # may part the two rollouts); the reward Longformer takes no knob, so
    # the rewards compare on the rows whose states both rollouts share
    set_env(proutes["kernel"])
    with torch.no_grad():
        v_k = critic_lib.value_produce(pst0.critic_params, pccfg, agent_d["state"])[:, None]
    restore_env()
    shared = (agent_k["state"] == agent_d["state"]).flatten(1).all(1, keepdim=True)
    e = max_err(v_k, agent_d["value"])
    print(f"[ppo_rollout] values across routes: max|diff| {e:.3e} (max "
          f"{magnitude(agent_d['value']):.3e})", flush=True)
    check(e <= 1e-4 * magnitude(agent_d["value"]), f"ppo rollout values: max|diff| {e}")
    e = ((agent_k["reward"] - agent_d["reward"]).abs() * shared).max().item()
    print(f"[ppo_rollout] rewards across routes on the {int(shared.sum())} of {SE} states both "
          f"rollouts share: max|diff| {e:.3e} (max {magnitude(agent_d['reward']):.3e})",
          flush=True)
    check(e <= 1e-4 * magnitude(agent_d["reward"]), f"ppo rollout rewards: max|diff| {e}")

    # -- 17b. the PPO rollout: a graph replay an episode against the eager loop
    pxs, pys, pms = (torch.from_numpy(a).to(dev) for a in
                     dataset.synthetic_cp_dataset(4, 512, n_class=avocab, seed=6))
    p_ret0 = ppo.calculate_returns(agent_d["reward"][:, 0], ppcfg.discount)
    p_adv0 = ppo.calculate_advantages(p_ret0, agent_d["value"])
    p_cmp = {}
    for name, envv in proutes.items():
        set_env(envv)
        pst, ptxs = ppo_fresh()
        hold = {"s": pst}

        def p_rollout(i, graph):
            return ppo.rollout_song(hold["s"], pcfgs, pxs[i], pys[i], pms[i], episodes=SE,
                                    n_states=NE, n_actions=NS, graph=graph)[0]

        def p_update():
            hold["s"], _ = ppo.update_policy_step(hold["s"], pcfgs, ppcfg, ptxs, agent_d,
                                                  expert_d, p_adv0, p_ret0)

        zero_counts()
        tfb.ffn_kernel_runs(reset=True)
        caps = teg.EpisodeLoop.captures
        p_cmp[name] = compare_rollouts(f"ppo_rollout {name}", p_rollout, 4, p_update,
                                       ("state", "action", "next_state"),
                                       ("log_action", "value", "reward"))
        torch.cuda.synchronize()
        counts, g_runs = read_counts(), tfb.ffn_kernel_runs()
        caps = teg.EpisodeLoop.captures - caps
        n_fwd = 2 * pacfg.n_layer + pccfg.n_layer
        # 6 songs each way, as in 12b: the wrappers count the eager episodes,
        # G its own forward runs, replays included
        on = name == "kernel"
        want = [0] * 8 + ([(6 * SE + caps) * per_ep + n_fwd, n_fwd] if on else [0, 0])
        want_runs = 12 * SE * per_ep + n_fwd if on else 0
        print(f"[ppo_rollout] {name} route: {caps} capture(s); the wrappers' eager launches "
              f"(C, D, E, F, G fwd/bwd) {counts}; G's forward runs as the kernel counts them "
              f"{g_runs}", flush=True)
        check(caps == 1, f"ppo rollouts, {name} route: {caps} captures, expected 1")
        check(counts == want, f"ppo rollouts, {name} route: launches {counts}, expected {want}")
        check(g_runs == want_runs, f"ppo rollouts, {name} route: G counted {g_runs} runs, "
              f"expected {want_runs}")
        del hold, pst, ptxs
    restore_env()
    p_ret = ppo.calculate_returns(agent_d["reward"][:, 0], ppcfg.discount)
    p_adv = ppo.calculate_advantages(p_ret, agent_d["value"])
    p_out, p_ms = {}, {}
    for name, envv in proutes.items():
        set_env(envv)
        pst, (atx, ctx) = ppo_fresh()
        zero_counts()
        pst, pmet = ppo.update_policy_step(pst, pcfgs, ppcfg, (atx, ctx), agent_d, expert_d,
                                           p_adv, p_ret)
        torch.cuda.synchronize()
        counts = read_counts()
        outs = []
        for tx_, prm, mu, losses in ((atx, pst.actor_params, pst.actor_opt.mu,
                                      [pmet["actor_loss"], pmet["policy_loss"]]),
                                     (ctx, pst.critic_params, pst.critic_opt.mu,
                                      [pmet["value_loss"]])):
            # the step's gradient from Adam's first moment, its update
            # recomputed from it (a first step from zeros), as phase 12
            g_tree = topt.tree_map(lambda m_: m_ / (1.0 - tx_.b1), mu)
            u_tree, _ = tx_.update(g_tree, tx_.init(g_tree))
            outs.append((float(losses[0]), torch.stack(losses).cpu(), named_leaves(prm),
                         named_leaves(g_tree), named_leaves(u_tree)))
            del g_tree, u_tree
        p_out[name] = outs
        vals = {k: float(v) for k, v in pmet.items()}
        print(f"[ppo_update] {name} route: {vals}; launches (C, D, E, F, G fwd/bwd) {counts}",
              flush=True)
        n_fwd = 2 * pacfg.n_layer + pccfg.n_layer        # policy and CE forwards, the critic's
        want = [0] * 8 + ([n_fwd, n_fwd] if name == "kernel" else [0, 0])
        check(counts == want, f"ppo update, {name} route: launches {counts}, expected {want}")
        t = time.perf_counter()
        for _ in range(2):
            pst, _ = ppo.update_policy_step(pst, pcfgs, ppcfg, (atx, ctx), agent_d, expert_d,
                                            p_adv, p_ret)
        torch.cuda.synchronize()
        p_ms[name] = (time.perf_counter() - t) / 2 * 1e3
        del pst, atx, ctx
    restore_env()
    # the policy loss is a mean of terms of size |advantage| (normalised: mean
    # 0, std 1) that largely cancel, so its difference is held against that
    # scale, not against the small mean
    pol_k, pol_d = p_out["kernel"][0][1][1].item(), p_out["default"][0][1][1].item()
    pol_scale = max(abs(pol_d), p_adv.abs().mean().item())
    print(f"[ppo_update] policy loss kernel {pol_k:.7f} default {pol_d:.7f}: difference "
          f"{abs(pol_k - pol_d):.3e} against a scale of {pol_scale:.3e}; {p_ms['default']:.1f} "
          f"ms per step (default), {p_ms['kernel']:.1f} ms (kernel G)", flush=True)
    check(abs(pol_k - pol_d) <= 1e-4 * pol_scale, f"ppo update: policy losses {pol_k}, {pol_d}")
    check_step("ppo_update actor", p_out["kernel"][0], p_out["default"][0])
    check_step("ppo_update critic", p_out["kernel"][1], p_out["default"][1])
    del p_out, p_roll

    # -- 18. the slice's main path: cli ppo-train on both routes ----------------
    pcli = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, envv in proutes.items():
            set_env(envv)
            ck = os.path.join(tmp, name, "ckpt")
            zero_counts()
            tfb.ffn_kernel_runs(reset=True)
            caps = teg.EpisodeLoop.captures
            res = cli.main(["ppo-train", "--synthetic", "--synthetic-songs", "4", "--seq-len",
                            "512", "--songs", "2", "--episodes", str(SE), "--n-states",
                            str(NE), "--n-actions", str(NS), "--ppo-steps", "10",
                            "--exp-dir", os.path.join(tmp, name, "exp"), "--ckpt-dir", ck])
            torch.cuda.synchronize()
            counts = read_counts()
            caps = teg.EpisodeLoop.captures - caps
            pcli[name] = (res, counts, tfb.ffn_kernel_runs())
            print(f"[ppo-train] {name} route: ms per rollout song ({SE} episodes) "
                  f"{res['rollout_ms']}; ms per update_policy (10 steps) {res['update_ms']}; "
                  f"metrics {res['metrics']}; launches (C, D, E, F, G fwd/bwd) {counts}",
                  flush=True)
            check(res["songs"] == 2 and len(res["metrics"]) == 2, f"ppo-train {name}: 2 songs")
            check(os.path.exists(os.path.join(ck, "ppo_best.ckpt")),
                  f"ppo-train {name}: no ppo_best.ckpt")
            check(all(math.isfinite(v) for m_ in res["metrics"] for v in m_.values()),
                  f"ppo-train {name}: a printed loss or reward is not finite")
            # G's forward runs (its own count): 2 songs of SE episodes and 2 x
            # 10 update steps; the wrapper counts the eager calls: each
            # capture's first episode and the updates
            on = name == "kernel"
            want_runs = 2 * (SE * per_ep + 10 * n_fwd) if on else 0
            want = [0] * 8 + ([caps * per_ep + 2 * 10 * n_fwd, 2 * 10 * n_fwd] if on
                              else [0, 0])
            check(caps >= 1, f"ppo-train {name}: the rollouts captured no graph")
            check(counts == want, f"ppo-train {name}: launches {counts}, expected {want}")
            g_runs = tfb.ffn_kernel_runs()
            check(g_runs == want_runs, f"ppo-train {name}: G counted {g_runs} runs, expected "
                  f"{want_runs}")
            cli_med = res["rollout_ms"][1]
            ratio = cli_med / p_cmp[name]["median_eager"]
            print(f"[ppo-train] {name} route: {caps} capture(s); G's forward runs as the "
                  f"kernel counts them "
                  f"{g_runs}; ms of the rollout song after the first {cli_med:.1f} (graph "
                  f"replays) against the eager loop's median {p_cmp[name]['median_eager']:.1f} "
                  f"(phase 17b): {ratio:.3f}", flush=True)
            check(ratio <= 1 / 3, f"ppo-train {name}: graphed rollout songs take {ratio:.3f} "
                  "of the eager loop's time, more than a third")
    restore_env()
    # G's forward runs as the kernel counts them; its backward runs eagerly
    # only (the updates), so the wrapper's count is its launches
    launches["G"] = (pcli["kernel"][2], pcli["kernel"][1][9])
    launches["G_eager"] = pcli["kernel"][1][8:10]

    # -- 19. cli pretrain on kernel G's route (RLMG_FFN_BACKEND=pallas) -------
    with tempfile.TemporaryDirectory() as tmp:
        set_env({"RLMG_FFN_BACKEND": "pallas"})
        zero_counts()
        tfb.ffn_kernel_runs(reset=True)
        res = cli.main(["pretrain", "--synthetic", "--synthetic-songs", "64", "--batch-size",
                        str(BT), "--seq-len", str(ST), "--max-steps", "4",
                        "--exp-dir", os.path.join(tmp, "exp"), "--ckpt-dir",
                        os.path.join(tmp, "ckpt")])
        torch.cuda.synchronize()
        counts = read_counts()
    restore_env()
    ms_step = res["seconds"] / res["steps"] * 1e3
    print(f"[pretrain] kernel-G route: {res['steps']} steps in {res['seconds']:.3f}s = "
          f"{ms_step:.1f} ms/step, {res['tokens_per_s']:.1f} tokens/s; logged losses "
          f"{res['batch_losses']}; launches (C, D, E, F, G fwd/bwd) {counts}", flush=True)
    check(res["steps"] == 4, f"pretrain on kernel G's route: {res['steps']} steps")
    check(len(res["batch_losses"]) > 0 and all(
        math.isfinite(v) for v in res["batch_losses"] + res["history"]),
        "pretrain on kernel G's route: a logged loss is not finite")
    want = [0] * 8 + [12 * 4, 12 * 4]
    check(counts == want, f"pretrain on kernel G's route: launches {counts}, expected {want}")
    g_runs = tfb.ffn_kernel_runs()
    check(g_runs == want[8], f"pretrain on kernel G's route: G counted {g_runs} forward runs")
    launches["G_pretrain"] = counts[8:10]

    # -- 20. cli inference: the PPO actor's 150 tokens to a tuple-event MIDI --
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gen_midi", "actor.mid")
        res = cli.main(["inference", "--tokens", "150", "--out", out])
        with open(out, "rb") as f:
            head = f.read(4)
    print(f"[inference] {res['tokens']} tokens, {res['notes']} notes in {res['seconds']:.3f}s "
          f"({res['tokens'] / res['seconds']:.1f} tokens/s)", flush=True)
    check(head == b"MThd", "inference: the output is not a MIDI file")
    check(res["tokens"] == res["notes"] == 150, f"inference: {res['notes']} notes, expected 150")

    lat_entries = latency_slice(cfg, params, dev, gen)      # phases 21-24
    aug_entries = aug_slice(cfg, params, dev, gen)          # phases 25-29
    serve = serving_slice(cfg, params, dev)                 # phases 31-33
    t_grp = time.perf_counter()
    dp_run(cfg, smi_line)                                    # phases 34-35
    print(f"[time] phases 34-35: {time.perf_counter() - t_grp:.1f}s ({smi_line})", flush=True)
    t_grp = time.perf_counter()
    tp_found = tp_run(cfg, smi_line)                         # phases 36-38
    print(f"[time] phases 36-38: {time.perf_counter() - t_grp:.1f}s ({smi_line})", flush=True)
    rl_found = rl_run(cfg, smi_line)                         # phases 39-41
    t_grp = time.perf_counter()
    sp_found = sp_run(smi_line)                              # phase 42
    print(f"[time] phase 42: {time.perf_counter() - t_grp:.1f}s ({smi_line})", flush=True)
    pp_found = pp_run(cfg, smi_line)                         # phases 43-44
    ckpt_found = ckpt_run(cfg, smi_line, dev)                # phase 45

    def tp_f_launches(dtype):
        """F's (fwd, bwd) wrapper launches on each rank of the tp steps of
        phases 36-37 on its route, by phase."""
        return {f"phase{ph}": [r[f"f_{dtype}"]["tp"]["counts"][6:8] for r in v["res"]]
                for ph, v in tp_found.items() if f"f_{dtype}" in v["res"][0]}

    def rl_launches(k):
        """(fwd, bwd) runs of F (k = 0), E (k = 2), G (k = 4) or D (k = 6) on
        each rank of phases 39-41's steps, by phase and step (F and E on its
        rank's n_head / tp heads; G at tp = 1, phase 40b; D in 40b's split
        discriminator epoch)."""
        return {f"phase{ph}": {name: [r[k:k + 2] for r in rs] for name, rs in v["runs"].items()}
                for ph, v in rl_found.items()}

    # -- 30. times at the main paths' shapes -------------------------------
    st = dk4.init_state(cfg, 5, device=dev)
    sdt = st.s.dtype
    h5 = lt.embed_input(params, cfg, rand_tokens(1, 5)[0], 0, None).float()
    wa = dk4.workspace(dparams, 5)
    a_ms = time_ms(lambda: dk4.fused_stack_step(None, h5, st.s, st.z, n_head=H, work=wa), 50)
    a_plain = time_ms(lambda: dk4.fused_stack_step_plain(dparams, h5, st.s, st.z,
                                                         n_head=H), 20)
    wts = dk4.layer_weights(dparams)
    a_bytes = nbytes(wts) + 2 * nbytes([st.s, st.z]) + 2 * h5.numel() * 4
    a_flops = 2 * 5 * L * (4 * D * D + 2 * D * DI) + 4 * L * 5 * H * E * E
    # the products on the tensor cores as six bf16 products (f32 weights)
    a_bound, a_by = bound(a_bytes, a_flops, SPLIT_BF16_FLOPS)
    # with bf16 weights (generate's default) and a bf16 state, at 1 to 128
    # songs: three bf16 products a product
    a_bf16 = {}
    wts16 = dk4.layer_weights(dparams_bf16)
    for b in (1, 5, 32, 64, 128):
        st_b = dk4.init_state(cfg, b, bf16, dev)
        h_b = lt.embed_input(params, cfg, rand_tokens(1, b)[0], 0, None).float()
        wa = dk4.workspace(dparams_bf16, b)
        ms = time_ms(lambda: dk4.fused_stack_step(None, h_b, st_b.s, st_b.z, n_head=H, work=wa),
                     30)
        pms = time_ms(lambda: dk4.fused_stack_step_plain(dparams_bf16, h_b, st_b.s, st_b.z,
                                                         n_head=H), 3)
        nb = nbytes(wts16) + 2 * nbytes([st_b.s, st_b.z]) + 2 * h_b.numel() * 4
        ops = 2 * b * L * (4 * D * D + 2 * D * DI) + 4 * L * b * H * E * E
        bd, by = bound(nb, ops, SPLIT3_BF16_FLOPS)
        a_bf16[b] = dict(ms=ms, plain_ms=pms, bound_ms=bd, bound_by=by)
        print(f"[time] decode_step B={b}, bf16 weights and state: {ms:.4f} ms a token, plain "
              f"{pms:.3f}, bound {bd:.4f} ({by})", flush=True)
        del st_b, wa

    # kernel B: a 128-token call at B=128 (and B=1024, bench.py's decode
    # shape) with the default bf16 state, f32 weights (bound at 989/6
    # TFLOP/s: six bf16 products a product; the f32 FMA bound beside) and
    # bf16 weights (bound at the bf16 tensor-core rate: v6 casts every
    # product's input to the weights' type)
    T6 = 128
    fold_rows = v6p.m.shape[0]
    b_t = {}
    for wdt, b in ((f32, b6), (bf16, b6), (bf16, 1024), (f32, 1024)):
        vp = v6p if wdt == f32 else v6p_bf16
        st6 = dk4.init_state(cfg, b, device=dev)
        tok_b = tok0[:1].repeat(b, 1)
        dk6.reset_counts()
        ms = time_ms(lambda: dk6.fused_decode_v6(vp, tok_b, st6.s, st6.z, 0, 1,
                                                 max_tokens=T6, **kw), 3)
        f6 = dk6.fused_decode_v6
        per_call = f6.cuda_launches / f6.tc_calls
        plain = None
        if b == b6:
            plain = time_ms(lambda: dk6.fused_decode_v6_plain(
                vp, tok_b, st6.s, st6.z, 0, 1, max_tokens=T6, n_head=H, temps=temps,
                topps=topps, eps=cfg.attn_eps), 1)
        ops, nb, floor_b = chunk_work(b, T6, L, D, DI, H, w_bytes=2 if wdt == bf16 else 4,
                                      s_bytes=st6.s.element_size(), fold_rows=fold_rows)
        bd, by = bound(nb, ops, BF16_FLOPS if wdt == bf16 else SPLIT_BF16_FLOPS)
        b_t[(wdt, b)] = dict(ms=ms, plain_ms=plain, bound_ms=bd, bound_by=by,
                             floor_ms=floor_b / HBM_BYTES_PER_S * 1e3, launches_per_call=per_call,
                             graph_kernels=f6.graph_kernels,
                             gflop=ops / 1e9, mb=nb / 1e6)
        if wdt == f32:
            b_t[(wdt, b)]["fma_bound_ms"] = bound(nb, ops)[0]
        plain_s = f"{plain:.3f}" if plain is not None else "not timed"
        fma_s = f", f32 FMA bound {b_t[(wdt, b)]['fma_bound_ms']:.4f}" if wdt == f32 else ""
        print(f"[time] decode_chunk B={b} T={T6} {str(wdt)[6:]} weights, "
              f"{str(st6.s.dtype)[6:]} state: {ms:.3f} ms, plain {plain_s} ms, bound {bd:.4f} ms "
              f"({by}; {ops / 1e9:.1f} GFLOP, {nb / 1e6:.1f} MB{fma_s}), state-streaming floor "
              f"{floor_b / HBM_BYTES_PER_S * 1e3:.3f} ms; {per_call:.0f} CUDA launches a call "
              f"({f6.graph_kernels} kernels in each token's graph)", flush=True)
        check(per_call == 1 + T6, f"decode_chunk B={b} {str(wdt)[6:]} weights: {per_call} CUDA "
                                  f"launches a call (1 + T = {1 + T6})")
        del st6
    b_ms, b_plain, b_bound, b_by = (b_t[(f32, b6)][k] for k in ("ms", "plain_ms", "bound_ms",
                                                                 "bound_by"))

    # the host's time to issue a one-token call of the tensor-core route by
    # what its graph needs: a new shape instantiates one, another state
    # tensor updates it in place, a new seed on the same tensors launches it
    # as it is (the card's work is queued behind; timed until the call
    # returns)
    f6 = dk6.fused_decode_v6
    host = {}
    for what, b, n_states in (("instantiate", b6 - 1, 1), ("update", b6, 2),
                              ("replay", b6, 1)):
        sts = [dk4.init_state(cfg, b, device=dev) for _ in range(n_states)]
        tok_b = tok0[:1].repeat(b, 1)
        if what != "instantiate":
            dk6.fused_decode_v6(v6p_bf16, tok_b, sts[-1].s, sts[-1].z, 0, 0, max_tokens=1, **kw)
        torch.cuda.synchronize()
        c0, u0, n, t_host = f6.captures, f6.updates, (1 if what == "instantiate" else 20), 0.0
        for i in range(n):
            st_i = sts[i % n_states]
            t = time.perf_counter()
            dk6.fused_decode_v6(v6p_bf16, tok_b, st_i.s, st_i.z, 0, i + 1, max_tokens=1, **kw)
            t_host += time.perf_counter() - t
        torch.cuda.synchronize()
        host[what] = dict(ms=t_host * 1e3 / n, captures=f6.captures - c0,
                          updates=f6.updates - u0)
        del sts
    print(f"[time] decode_chunk tensor cores, host ms to issue a one-token call (B={b6}): "
          + ", ".join(f"{k} {v['ms']:.3f} ({v['captures']} instantiated, {v['updates']} "
                      f"updated in {n})" for k, v in host.items()
                      for n in [1 if k == "instantiate" else 20]), flush=True)
    check(host["replay"]["captures"] == host["update"]["captures"] == 0,
          f"decode_chunk: calls of one shape instantiated a graph ({host})")
    print(f"[time] decode_step B=5 (f32 weights, {str(sdt)[6:]} state): {a_ms:.3f} ms, "
          f"plain {a_plain:.3f} ms, bound {a_bound:.4f} ms ({a_by})")

    # C at both dtypes: through the wrapper and autograd, and its parts
    # alone (the projection; the attention passes forward and backward),
    # CUDA events and the profiler's device time; bounds at the route's
    # rates (the projection at 989 TFLOP/s for bf16 tensors, 989/6 for f32;
    # the attention's f32-grade products at 989/6 at both), the f32 FMA
    # bound beside
    c_t = {}
    for dt in (torch.float32, torch.bfloat16):
        ins = c_in if dt == torch.float32 else as_bf16(c_in)
        h_c, w_c, b_c = ins
        g_c = g_tr.to(dt)
        k_f, k_b = time_fwd_bwd(c_kernel, ins, g_c, 20)
        p_f, p_b = time_fwd_bwd(c_plain, ins, g_c, 5)
        att_c, pqkv_c, den_c = tab.forward_kernel(h_c, w_c, b_c, BT, H, cfg.attn_eps)
        x_c = tab.project_kernel(h_c, w_c, b_c)[1]
        parts = {"proj": lambda: tab.project_kernel(h_c, w_c, b_c),
                 "attn_fwd": lambda: tab.attention_kernel(x_c, BT, H, cfg.attn_eps, dt),
                 "attn_bwd": lambda: tab.backward_kernel(pqkv_c, g_c, att_c, den_c, BT, H,
                                                         cfg.attn_eps)}
        work = qkv_attention_work(NT, D, H, BT, elem=h_c.element_size())
        p_rate = BF16_FLOPS if dt == torch.bfloat16 else SPLIT_BF16_FLOPS
        rates = {"proj": p_rate, "attn_fwd": SPLIT_BF16_FLOPS, "attn_bwd": SPLIT_BF16_FLOPS}
        row = {"dtype": str(dt)[6:], "ms_fwd": k_f, "ms_bwd": k_b, "plain_ms_fwd": p_f,
               "plain_ms_bwd": p_b}
        for part, fn in parts.items():
            ops, nb = work[part]
            row[f"{part}_ms"] = time_ms(fn, 20)
            row[f"{part}_device_ms"] = device_ms(fn, 20)
            row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = bound(nb, ops, rates[part])
            row[f"{part}_fma_bound_ms"] = bound(nb, ops)[0]
        # whole calls: the bytes against the sum of the parts' operation
        # times (the dh / dW / db products at the projection's rate)
        grad_ops = work["bwd"][0] - work["attn_bwd"][0]
        t_ops = {"fwd": work["proj"][0] / p_rate + work["attn_fwd"][0] / SPLIT_BF16_FLOPS,
                 "bwd": grad_ops / p_rate + work["attn_bwd"][0] / SPLIT_BF16_FLOPS}
        for way in ("fwd", "bwd"):
            ops, nb = work[way]
            t_b = nb / HBM_BYTES_PER_S
            row[f"bound_ms_{way}"] = max(t_b, t_ops[way]) * 1e3
            row[f"bound_by_{way}"] = "bytes" if t_b >= t_ops[way] else "operations"
            row[f"fma_bound_ms_{way}"] = bound(nb, ops)[0]
            row[f"gflop_{way}"], row[f"mb_{way}"] = ops / 1e9, nb / 1e6
        c_t[dt] = row
        print(f"[time] qkv_attention N={NT} {row['dtype']}: forward {k_f:.4f} ms (plain "
              f"{p_f:.3f}, bound {row['bound_ms_fwd']:.4f} {row['bound_by_fwd']}, f32 FMA "
              f"bound {row['fma_bound_ms_fwd']:.4f}), backward {k_b:.4f} ms (plain {p_b:.3f}, "
              f"bound {row['bound_ms_bwd']:.4f} {row['bound_by_bwd']}, f32 FMA bound "
              f"{row['fma_bound_ms_bwd']:.4f}); " + "; ".join(
                  f"{part} {row[f'{part}_ms']:.4f} ms (device {row[f'{part}_device_ms']:.4f}, "
                  f"bound {row[f'{part}_bound_ms']:.4f} {row[f'{part}_bound_by']}, f32 FMA "
                  f"{row[f'{part}_fma_bound_ms']:.4f})" for part in parts), flush=True)
        if dt == torch.float32:
            att_k = att_c
        del att_c, pqkv_c, den_c, x_c, parts
    c32 = c_t[torch.float32]
    print(f"[time] train step B={BT} S={ST}: kernel route {step_ms['kernel']:.1f} ms, plain "
          f"route {step_ms['plain']:.1f} ms")

    # D at both dtypes and both of its paths' shapes, dropout 0.1
    d_tr = (h_tr, att_k.contiguous(), *tail_ws)
    d_lf = (h_lf, a_lf, *lf_ws)
    d_t = {}
    for dt in (torch.float32, torch.bfloat16):
        for tag, ins, gg, mid, work in (
                ("pretrain", d_tr, g_tr, True, lambda el: attn_tail_work(NT, D, DI, el)),
                ("longformer", d_lf, g_lf, False,
                 lambda el: attn_tail_work(ND, dcfg.d_model, dcfg.d_inner, el))):
            d_t[tag, dt] = fused_times(
                f"attn_tail {tag} N={ins[0].shape[0]} DI={ins[6].shape[1]} p=0.1 "
                f"mid_drop={mid}", lambda *a, m=mid: tfb.attn_tail_block(*a, seed_t, 0.1, m),
                lambda *a, m=mid: tfb.attn_tail_block_plain(*a, seed_t, 0.1, m),
                [t.to(dt) for t in ins], gg.to(dt), 10, work, tfb.attn_tail_block)
            torch.cuda.empty_cache()
    for (tag, dt), err in (
            (("pretrain", torch.float32), d_err), (("pretrain", torch.bfloat16), d_err_bf16),
            (("longformer", torch.float32), d_lf_err),
            (("longformer", torch.bfloat16), d_lf_err_bf16)):
        d_t[tag, dt]["max_abs_err"] = err

    e_in = (q_e, k_e, v_e)
    e_fwd, e_bwd = time_fwd_bwd(e_kernel(dms), e_in, g_e, 20)
    e_pf, e_pb = time_fwd_bwd(e_plain(dms), e_in, g_e, 5)
    e_lf, e_lb = time_fwd_bwd(e_lib, e_in, g_e, 10)
    (ef_ops, ef_b), (eb_ops, eb_b), pairs, kept_pairs = window_work(BD, HD, SD, ED, WD, dms)
    # at f32 grade on the tensor cores (six bf16 products a product), the
    # f32 FMA bound beside
    e_bf, e_bfby = bound(ef_b, ef_ops, SPLIT_BF16_FLOPS)
    e_bb, e_bbby = bound(eb_b, eb_ops, SPLIT_BF16_FLOPS)
    e_fma_f, e_fma_b = bound(ef_b, ef_ops)[0], bound(eb_b, eb_ops)[0]
    ek_bf, _ = bound(ef_b, ef_ops * kept_pairs / pairs, SPLIT_BF16_FLOPS)
    ek_bb, _ = bound(eb_b, eb_ops * kept_pairs / pairs, SPLIT_BF16_FLOPS)
    e_dev_f = device_ms(lambda: twk.forward_kernel(q_e, k_e, v_e, dms, WIN), 10)
    o_e, st_e = twk.forward_kernel(q_e, k_e, v_e, dms, WIN)
    e_dev_b = device_ms(lambda: twk.backward_kernel(q_e, k_e, v_e, dms, o_e, st_e, g_e, WIN), 10)
    print(f"[time] window_attention B={BD} H={HD} S={SD} D={ED} w={WD}: forward {e_fwd:.3f} ms "
          f"(device {e_dev_f:.4f}; plain {e_pf:.3f}, library {e_lf:.3f}, bound {e_bf:.4f} "
          f"{e_bfby}, f32 FMA bound {e_fma_f:.4f}, {ef_ops / 1e9:.2f} GFLOP), backward "
          f"{e_bwd:.3f} ms (device {e_dev_b:.4f}; plain {e_pb:.3f}, library {e_lb:.3f}, bound "
          f"{e_bb:.4f} {e_bbby}, f32 FMA bound {e_fma_b:.4f}, {eb_ops / 1e9:.2f} GFLOP); bounds "
          f"count {pairs} (query, key) pairs of the band; the {kept_pairs} with both kept would "
          f"give {ek_bf:.4f} / {ek_bb:.4f} ms")
    # E on bf16 tensors at the same shape: the bound at bf16 bytes and the
    # bf16 peak (the least the card could take for bf16 inputs), the rate of
    # the kernel's f32-grade products (989/6) beside; the library call on the
    # same bf16 tensors with the mask in bf16
    e16 = as_bf16((q_e, k_e, v_e))
    g_e16, mask16 = g_e.bfloat16(), lib_mask.bfloat16()
    e16_f, e16_b = time_fwd_bwd(e_kernel(dms), e16, g_e16, 20)
    e16_pf, e16_pb = time_fwd_bwd(e_plain(dms), e16, g_e16, 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    e16_lf, e16_lb = time_fwd_bwd(lambda q_, k_, v_: sdpa(q_, k_, v_, attn_mask=mask16), e16,
                                  g_e16, 10)
    (f16_ops, f16_b), (b16_ops, b16_b), _, _ = window_work(BD, HD, SD, ED, WD, dms, elem=2)
    e16_bf, e16_bfby = bound(f16_b, f16_ops, BF16_FLOPS)
    e16_bb, e16_bbby = bound(b16_b, b16_ops, BF16_FLOPS)
    e16_gf, e16_gb = bound(f16_b, f16_ops, SPLIT_BF16_FLOPS)[0], bound(b16_b, b16_ops,
                                                                      SPLIT_BF16_FLOPS)[0]
    e16_dev_f = device_ms(lambda: twk.forward_kernel(*e16, dms, WIN), 10)
    o16, st16 = twk.forward_kernel(*e16, dms, WIN)
    e16_dev_b = device_ms(lambda: twk.backward_kernel(*e16, dms, o16, st16, g_e16, WIN), 10)
    print(f"[time] window_attention bf16 B={BD} H={HD} S={SD} D={ED} w={WD}: forward "
          f"{e16_f:.3f} ms (device {e16_dev_f:.4f}; plain {e16_pf:.3f}, library {e16_lf:.3f}, "
          f"bound {e16_bf:.4f} {e16_bfby}, at the f32-grade products' rate {e16_gf:.4f}; "
          f"{f16_b / 1e6:.1f} MB), backward {e16_b:.3f} ms (device {e16_dev_b:.4f}; plain "
          f"{e16_pb:.3f}, library {e16_lb:.3f}, bound {e16_bb:.4f} {e16_bbby}, at the "
          f"f32-grade products' rate {e16_gb:.4f}; {b16_b / 1e6:.1f} MB) ({smi_line})",
          flush=True)
    del e16, g_e16, mask16, o16, st16
    print(f"[time] discriminator-LM step B={BD} S={SD}: default route (kernel D) "
          f"{dstep_ms['default']:.1f} ms, window route (kernel E) {dstep_ms['window']:.1f} ms, "
          f"plain route {dstep_ms['plain']:.1f} ms")

    f_t = {}
    for tag in ("rollout", "dqn", "pretrain"):
        pq, pk, v_f, g_f = f_in[tag]
        reps = 50 if tag != "pretrain" else 20
        fk, bk = time_fwd_bwd(f_kernel, (pq, pk, v_f), g_f, reps)
        fp, bp = time_fwd_bwd(f_plain, (pq, pk, v_f), g_f, 10)
        # the card's own time a call (the kernels under the profiler) beside
        # the back-to-back time, which the host paces where it is slower
        o_f, d_f = tlk.forward_kernel(pq, pk, v_f, cfg.attn_eps)
        c0 = tlk.causal_product.cuda_launches
        dfk = device_ms(lambda: tlk.forward_kernel(pq, pk, v_f, cfg.attn_eps), reps)
        c1 = tlk.causal_product.cuda_launches
        dbk = device_ms(lambda: tlk.backward_kernel(pq, pk, v_f, o_f, d_f, g_f, cfg.attn_eps),
                        reps)
        n_fl, n_bl = (c1 - c0) // (reps + 1), (tlk.causal_product.cuda_launches - c1) // (reps + 1)
        hfk = time_ms(lambda: tlk.forward_kernel(pq, pk, v_f, cfg.attn_eps), reps)
        hbk = time_ms(lambda: tlk.backward_kernel(pq, pk, v_f, o_f, d_f, g_f, cfg.attn_eps), reps)
        (ff_ops, ff_b), (fb_ops, fb_b) = causal_product_work(*f_shapes[tag])
        (bf, bfby), (bb, bbby) = (bound(ff_b, ff_ops, SPLIT_BF16_FLOPS),
                                  bound(fb_b, fb_ops, SPLIT_BF16_FLOPS))
        fma_f, fma_b = bound(ff_b, ff_ops)[0], bound(fb_b, fb_ops)[0]
        f_t[tag] = dict(ms_fwd=fk, ms_bwd=bk, device_ms_fwd=dfk, device_ms_bwd=dbk,
                        host_bound_ms_fwd=hfk, host_bound_ms_bwd=hbk, plain_ms_fwd=fp,
                        plain_ms_bwd=bp, bound_ms_fwd=bf, bound_ms_bwd=bb, bound_by_fwd=bfby,
                        bound_by_bwd=bbby,
                        bound_by=bound(ff_b + fb_b, ff_ops + fb_ops, SPLIT_BF16_FLOPS)[1],
                        fma_bound_ms_fwd=fma_f, fma_bound_ms_bwd=fma_b,
                        cuda_launches_fwd=n_fl, cuda_launches_bwd=n_bl,
                        gflop_fwd=ff_ops / 1e9, gflop_bwd=fb_ops / 1e9, mb_fwd=ff_b / 1e6,
                        mb_bwd=fb_b / 1e6, max_abs_err=f_err[tag])
        print(f"[time] causal_product {tag} {f_shapes[tag]}: forward {fk:.4f} ms through the "
              f"wrapper (device {dfk:.4f}, forward_kernel back to back {hfk:.4f}; plain "
              f"{fp:.4f}, bound {bf:.5f} {bfby}, f32 FMA bound {fma_f:.5f}; {ff_ops / 1e9:.3f} "
              f"GFLOP, {ff_b / 1e6:.1f} MB; {n_fl} CUDA launches), backward {bk:.4f} ms "
              f"(device {dbk:.4f}, backward_kernel back to back {hbk:.4f}; plain {bp:.4f}, "
              f"bound {bb:.5f} {bbby}, f32 FMA bound {fma_b:.5f}; {fb_ops / 1e9:.3f} GFLOP, "
              f"{fb_b / 1e6:.1f} MB; {n_bl} CUDA launches)", flush=True)
    # F on bf16 tensors at the rollout, ragged and pretrain shapes: bounds at
    # bf16 bytes and the bf16 peak, the rate of its f32-grade products beside
    f16_t = {}
    for tag in ("rollout", "ragged", "pretrain"):
        pq, pk, v_f, g_f = as_bf16(f_in[tag])
        reps = 50 if tag != "pretrain" else 20
        fk, bk = time_fwd_bwd(f_kernel, (pq, pk, v_f), g_f, reps)
        fp, bp = time_fwd_bwd(f_plain, (pq, pk, v_f), g_f, 10)
        o_f, d_f = tlk.forward_kernel(pq, pk, v_f, cfg.attn_eps)
        dfk = device_ms(lambda: tlk.forward_kernel(pq, pk, v_f, cfg.attn_eps), reps)
        dbk = device_ms(lambda: tlk.backward_kernel(pq, pk, v_f, o_f, d_f, g_f, cfg.attn_eps),
                        reps)
        (ff_ops, ff_b), (fb_ops, fb_b) = causal_product_work(*f_shapes[tag], elem=2)
        (bf, bfby), (bb, bbby) = bound(ff_b, ff_ops, BF16_FLOPS), bound(fb_b, fb_ops, BF16_FLOPS)
        gf, gb = bound(ff_b, ff_ops, SPLIT_BF16_FLOPS)[0], bound(fb_b, fb_ops, SPLIT_BF16_FLOPS)[0]
        f16_t[tag] = dict(ms_fwd=fk, ms_bwd=bk, device_ms_fwd=dfk, device_ms_bwd=dbk,
                          plain_ms_fwd=fp, plain_ms_bwd=bp, bound_ms_fwd=bf, bound_ms_bwd=bb,
                          bound_by_fwd=bfby, bound_by_bwd=bbby,
                          bound_by=bound(ff_b + fb_b, ff_ops + fb_ops, BF16_FLOPS)[1],
                          f32_grade_bound_ms_fwd=gf, f32_grade_bound_ms_bwd=gb,
                          mb_fwd=ff_b / 1e6, mb_bwd=fb_b / 1e6,
                          max_abs_err=f_read16[tag]["out"]["max_abs"],
                          shares={n_: r["kernel"] for n_, r in f_read16[tag].items()})
        print(f"[time] causal_product bf16 {tag} {f_shapes[tag]}: forward {fk:.4f} ms through "
              f"the wrapper (device {dfk:.4f}; plain {fp:.4f}, bound {bf:.5f} {bfby}, at the "
              f"f32-grade products' rate {gf:.5f}; {ff_b / 1e6:.1f} MB), backward {bk:.4f} ms "
              f"(device {dbk:.4f}; plain {bp:.4f}, bound {bb:.5f} {bbby}, at the f32-grade "
              f"products' rate {gb:.5f}; {fb_b / 1e6:.1f} MB) ({smi_line})", flush=True)
    print(f"[time] DQN update B={BQ} x S={SQ}: default route {q_ms['default']:.1f} ms, kernel-F "
          f"route {q_ms['kernel']:.1f} ms")

    # G at the rollout's and the update's rows (dropout 0, as PPO runs them)
    # and pretrain's (dropout 0.1), at both dtypes
    g_t = {}
    for tag, p_drop, reps in (("rollout", 0.0, 50), ("update", 0.0, 20), ("pretrain", 0.1, 10)):
        h_g, gg = g_in[tag]
        for dt in (torch.float32, torch.bfloat16):
            g_t[tag, dt] = fused_times(
                f"ffn_block {tag} N={g_rows[tag]} p={p_drop}",
                lambda *a, p_=p_drop: tfb.ffn_block(*a, seed_t, p_),
                lambda *a, p_=p_drop: tfb.ffn_block_plain(*a, seed_t, p_),
                [t.to(dt) for t in (h_g, *ffn_ws)], gg.to(dt), reps,
                lambda el, n_=g_rows[tag]: ffn_work(n_, D, DI, el), tfb.ffn_block)
            g_t[tag, dt].update(rows=g_rows[tag], dropout=p_drop,
                                max_abs_err=g_err[tag] if dt == torch.float32 else
                                g_err[tag, "bf16"])
    p_def, p_ker = pcli["default"][0], pcli["kernel"][0]
    print(f"[time] PPO update step B={SE} x S={NE}: default route {p_ms['default']:.1f} ms, "
          f"kernel-G route {p_ms['kernel']:.1f} ms; ppo-train per rollout song "
          f"{p_def['rollout_ms']} / {p_ker['rollout_ms']} ms, per update_policy "
          f"{p_def['update_ms']} / {p_ker['update_ms']} ms (default / kernel G)")

    pkg = "reinforcement_learning_in_music_generation_torch"
    tpu = "reinforcement_learning_in_music_generation_tpu/ops"
    d32, g32 = d_t["pretrain", torch.float32], g_t["update", torch.float32]
    kernels = [
        # A with f32 weights at B=5 (the default bf16 state); generate's bf16
        # weights at 1-128 songs beside, and the per-step token graph
        {"name": "decode_step_v4", "route": "cuda", "source": f"{pkg}/csrc/decode_step.cu",
         "replaces": f"{tpu}/decode_kernel_v4.py:155", "launches": launches["v4"],
         "max_abs_err": a_err, "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": None, "cuda_launches_per_token": a_cuda_per_token,
         "runs_per_token_generate": graph_win["bfloat16"]["kernel_runs"]
         / graph_win["bfloat16"]["tokens"], "bf16_rounding_control_min_max_dh": a_ctrl,
         "hmma": {k.split(":")[1][:60]: n for k, n in stack_mma.items()
                  if k.startswith("decode_step")},
         "bf16_weights_by_batch": {str(b): r for b, r in a_bf16.items()},
         "per_step_token_graph": {k: {kk: vv for kk, vv in w.items() if kk != "host_calls"}
                                  for k, w in graph_win.items()},
         # runs as the kernel counts them on the serving paths: the
         # continuous batcher's timed requests at both weight types (phase
         # 31), generate --continuous and the 5-song prompt (32), serve (33)
         "launches_serve_loop": serve["runs_serve"],
         "launches_continuous_cli": serve["runs_prompt"]["continuous_cli"],
         "launches_prompt": serve["runs_prompt"]["A"],
         "launches_serve_cli": serve["serve_a_runs"],
         "serving": serve["figures"], "serve_requests_per_s": serve["requests_per_s"]},
        # B with f32 weights (f32-grade products on the tensor cores) at
        # B=128, and at B=1024; bound at 989/6 TFLOP/s, the f32 FMA bound
        # beside
        {"name": "decode_chunk_v6", "route": "cuda",
         "source": f"{pkg}/csrc/decode_chunk_tc.cuh",
         "replaces": f"{tpu}/decode_kernel_v6.py:364", "launches": launches["v6"],
         "weights": "float32", "max_abs_err": b_err[f32], "ms": b_ms, "plain_ms": b_plain,
         "bound_ms": b_bound, "bound_by": b_by, "library_ms": None,
         "fma_bound_ms": b_t[(f32, b6)]["fma_bound_ms"],
         "state_floor_ms": b_t[(f32, b6)]["floor_ms"],
         "cuda_launches_per_call": b_t[(f32, b6)]["launches_per_call"],
         "graph_kernels": b_t[(f32, b6)]["graph_kernels"], "hmma": b_mma_f32,
         "max_share_of_magnitude": b_share[f32],
         "bf16_weights_control_share": b_share["control_f32_weights"],
         "main_path_launches": tc_launch["v6"], "b1024": b_t[(f32, 1024)]},
        # the same kernel with bf16 weights (generate's default) at B=128,
        # and at B=1024
        {"name": "decode_chunk_v6_tc", "route": "cuda",
         "source": f"{pkg}/csrc/decode_chunk_tc.cuh",
         "replaces": f"{tpu}/decode_kernel_v6.py:364", "launches": launches["v6_tc"],
         "launches_prompt": serve["runs_prompt"]["B"], "weights": "bfloat16",
         "max_abs_err": b_err[bf16], "ms": b_t[(bf16, b6)]["ms"],
         "plain_ms": b_t[(bf16, b6)]["plain_ms"], "bound_ms": b_t[(bf16, b6)]["bound_ms"],
         "bound_by": b_t[(bf16, b6)]["bound_by"], "library_ms": None,
         "state_floor_ms": b_t[(bf16, b6)]["floor_ms"],
         "cuda_launches_per_call": b_t[(bf16, b6)]["launches_per_call"],
         "graph_kernels": b_t[(bf16, b6)]["graph_kernels"],
         "hmma": {k: n for k, n in b_mma.items() if k not in b_mma_f32},
         "main_path_launches": tc_launch["v6_tc"], "host_ms_per_call": host,
         "b1024": b_t[(bf16, 1024)]},
        # C at pretrain's 16384 rows, f32 (the CLI default), bf16 beside;
        # launches as its attention passes count their runs in `cli
        # pretrain`; bounds at the route's rates
        {"name": "qkv_attention_block", "route": "cuda",
         "source": f"{pkg}/csrc/attention_block.cu",
         "sources": [f"{pkg}/csrc/attention_block.cu", f"{pkg}/csrc/train_gemm_wg.cuh",
                     f"{pkg}/csrc/train_split.cuh", f"{pkg}/csrc/causal_product.cuh"],
         "replaces": f"{tpu}/attention_block.py:346", "launches": sum(launches["C"]),
         "launches_fwd": launches["C"][0], "launches_bwd": launches["C"][1],
         "launches_bf16": sum(launches["C_bf16"]),
         "launches_ckpt": {"phase45": ckpt_found["step_counts"][0:2]},
         "max_abs_err": c_err, "ms": c32["ms_fwd"] + c32["ms_bwd"],
         "plain_ms": c32["plain_ms_fwd"] + c32["plain_ms_bwd"],
         "bound_ms": c32["bound_ms_fwd"] + c32["bound_ms_bwd"],
         "bound_by": c32["bound_by_fwd"] if c32["bound_by_fwd"] == c32["bound_by_bwd"]
         else "operations", "library_ms": None,
         **{k: v for k, v in c32.items() if k != "dtype"}, "bf16": c_t[torch.bfloat16],
         "bf16_shares": c_share_bf16, "hgmma": c_mma},
        # D at pretrain's 16384 rows, f32 (the CLI default); bf16 and the
        # Longformer's shape beside; bounds at the route's tensor-core rate
        {"name": "attn_tail_block", "route": "cuda", "source": f"{pkg}/csrc/attn_tail.cu",
         "replaces": f"{tpu}/ffn_block.py:419", "launches": sum(launches["D"]),
         "launches_fwd": launches["D"][0], "launches_bwd": launches["D"][1],
         "max_abs_err": d_err, "ms": d32["ms_fwd"] + d32["ms_bwd"],
         "plain_ms": d32["plain_ms_fwd"] + d32["plain_ms_bwd"],
         "bound_ms": d32["bound_ms_fwd"] + d32["bound_ms_bwd"], "bound_by": d32["bound_by"],
         "library_ms": None, **{k: v for k, v in d32.items() if k != "bound_by"},
         "launches_bf16": sum(launches["D_bf16"]),
         "launches_discrim": sum(launches["D_discrim"]), "hmma": dg_mma["attn_tail"],
         # phase 40b: D's (fwd, bwd) on each rank's rows of the split
         # discriminator epoch; phase 45: C's and D's in the step before the
         # timed saves
         "launches_rl_mesh": {ph: v for ph, v in rl_launches(6).items() if ph == "phase40b"},
         "launches_ckpt": {"phase45": ckpt_found["step_counts"][2:4]},
         # phase 43: D's (fwd, bwd) on each pipeline stage, (n_layer / pp) x m
         "launches_pp": {f"phase{ph}": [r["counts"][2:4] for r in v["res"]]
                         for ph, v in pp_found.items() if ph != 44},
         "pp_ms": {f"phase{ph}": {"ranks": [r.get("ms") for r in v["res"]],
                                  "single": v["res"][0].get("ms_single")}
                   for ph, v in pp_found.items() if ph != 44},
         "bf16": d_t["pretrain", torch.bfloat16],
         "longformer_shape": {"rows": ND, "d_inner": dcfg.d_inner,
                              **d_t["longformer", torch.float32],
                              "bf16": d_t["longformer", torch.bfloat16]}},
        # E at the discriminator LM's shape; bound at 989/6 TFLOP/s (its
        # products at f32 grade on the tensor cores), the f32 FMA bound beside
        {"name": "window_attention_band", "route": "cuda",
         "source": f"{pkg}/csrc/window_attention.cu",
         "replaces": f"{tpu}/window_attention_kernel.py:203", "launches": sum(launches["E"]),
         "launches_fwd": launches["E"][0], "launches_bwd": launches["E"][1],
         "max_abs_err": e_err, "ms": e_fwd + e_bwd, "ms_fwd": e_fwd, "ms_bwd": e_bwd,
         "device_ms_fwd": e_dev_f, "device_ms_bwd": e_dev_b,
         "plain_ms": e_pf + e_pb, "bound_ms": e_bf + e_bb, "bound_ms_fwd": e_bf,
         "bound_ms_bwd": e_bb, "bound_by": e_bfby if e_bfby == e_bbby else "operations",
         "fma_bound_ms_fwd": e_fma_f, "fma_bound_ms_bwd": e_fma_b,
         "library_ms": e_lf + e_lb, "library_ms_fwd": e_lf, "library_ms_bwd": e_lb,
         "max_share_of_magnitude": e_share, "bf16_rounding_control_share": e_ctl,
         "hmma": e_mma, "launches_rl_mesh": rl_launches(2)},
        # F at a DQN update's shape; no single PyTorch call computes causal
        # linear attention (scaled_dot_product_attention is softmax attention);
        # bound at the rate of its six bf16 products a product (989/6 TFLOP/s),
        # the f32 FMA bound of earlier PRs beside; launches as the kernel counts
        # its runs (graph replays included), the wrapper's eager calls beside
        {"name": "causal_product", "route": "cuda", "source": f"{pkg}/csrc/causal_product.cu",
         "replaces": f"{tpu}/linear_attention.py:225", "launches": sum(launches["F"]),
         "launches_fwd": launches["F"][0], "launches_bwd": launches["F"][1],
         "eager_calls_fwd": launches["F_eager"][0], "eager_calls_bwd": launches["F_eager"][1],
         "max_abs_err": f_err["dqn"], "ms": f_t["dqn"]["ms_fwd"] + f_t["dqn"]["ms_bwd"],
         "device_ms": f_t["dqn"]["device_ms_fwd"] + f_t["dqn"]["device_ms_bwd"],
         "device_us_rollout_fwd": f_t["rollout"]["device_ms_fwd"] * 1e3,
         "host_bound_us_rollout_fwd": f_t["rollout"]["host_bound_ms_fwd"] * 1e3,
         "plain_ms": f_t["dqn"]["plain_ms_fwd"] + f_t["dqn"]["plain_ms_bwd"],
         "bound_ms": f_t["dqn"]["bound_ms_fwd"] + f_t["dqn"]["bound_ms_bwd"],
         "fma_bound_ms": f_t["dqn"]["fma_bound_ms_fwd"] + f_t["dqn"]["fma_bound_ms_bwd"],
         "bound_by": f_t["dqn"]["bound_by"],
         "library_ms": None, "dqn_shape": f_t["dqn"], "rollout_shape": f_t["rollout"],
         "pretrain_shape": f_t["pretrain"], "launches_pretrain": sum(launches["F_pretrain"]),
         "launches_tp": tp_f_launches("float32"),
         "launches_rl_mesh": rl_launches(0),
         # phase 42: F's own runs (fwd, bwd) on each sp rank's (32, 8, 256, 64)
         "launches_sp": {"phase42": [r["runs"] for r in sp_found["res"]]},
         # phase 45: F's (fwd, bwd) on each rank of cli pretrain --dp 2 --tp 2
         "launches_ckpt_cli": {"phase45": ckpt_found["cli_counts"]},
         "sp_ms": {"ranks": [r["ms"] for r in sp_found["res"]],
                   "single": sp_found["res"][0].get("ms_single")},
         "dqn_rollout_song": {k: {kk: vv for kk, vv in v.items() if "window" not in kk}
                              | {"busy_graphed": v["window_graphed"]["busy"],
                                 "busy_eager": v["window_eager"]["busy"],
                                 "host_launches_graphed": v["window_graphed"]["host_launches"],
                                 "host_launches_eager": v["window_eager"]["host_launches"]}
                              for k, v in q_roll.items()}},
        # F on bf16 tensors at the pretrain shape, the main path's (cli pretrain
        # --dtype bfloat16 under RLMG_ATTN_BACKEND=pallas, phase 6); bound at
        # bf16 bytes and the bf16 peak, the rate of its f32-grade products
        # beside; the rollout and ragged shapes beside
        {"name": "causal_product_bf16", "route": "cuda",
         "source": f"{pkg}/csrc/causal_product.cu",
         "replaces": f"{tpu}/linear_attention.py:225", "launches": sum(launches["F_bf16"]),
         "launches_fwd": launches["F_bf16"][0], "launches_bwd": launches["F_bf16"][1],
         "dtype": "bfloat16", "max_abs_err": f16_t["pretrain"]["max_abs_err"],
         "ms": f16_t["pretrain"]["ms_fwd"] + f16_t["pretrain"]["ms_bwd"],
         "device_ms": f16_t["pretrain"]["device_ms_fwd"] + f16_t["pretrain"]["device_ms_bwd"],
         "plain_ms": f16_t["pretrain"]["plain_ms_fwd"] + f16_t["pretrain"]["plain_ms_bwd"],
         "bound_ms": f16_t["pretrain"]["bound_ms_fwd"] + f16_t["pretrain"]["bound_ms_bwd"],
         "bound_by": f16_t["pretrain"]["bound_by"], "library_ms": None,
         "f32_grade_bound_ms": f16_t["pretrain"]["f32_grade_bound_ms_fwd"]
         + f16_t["pretrain"]["f32_grade_bound_ms_bwd"],
         "bf16_gates": F_BF16_GATES, "readings": f_read16,
         **{f"{tag}_shape": f16_t[tag] for tag in f16_t},
         "pretrain_profiled_step_top5": f16_top, "remat": remat_t,
         "launches_tp": tp_f_launches("bfloat16")},
        # E on bf16 tensors at the discriminator LM's shape (the LM with bf16
        # parameters under RLMG_WINDOW_BACKEND=pallas, phase 9); bound at
        # bf16 bytes and the bf16 peak, the f32-grade rate beside; the
        # library call on the same bf16 tensors
        {"name": "window_attention_band_bf16", "route": "cuda",
         "source": f"{pkg}/csrc/window_attention.cu",
         "replaces": f"{tpu}/window_attention_kernel.py:203", "launches": sum(launches["E_bf16"]),
         "launches_fwd": launches["E_bf16"][0], "launches_bwd": launches["E_bf16"][1],
         "dtype": "bfloat16", "max_abs_err": e_err16, "ms": e16_f + e16_b, "ms_fwd": e16_f,
         "ms_bwd": e16_b, "device_ms_fwd": e16_dev_f, "device_ms_bwd": e16_dev_b,
         "plain_ms": e16_pf + e16_pb, "bound_ms": e16_bf + e16_bb, "bound_ms_fwd": e16_bf,
         "bound_ms_bwd": e16_bb, "bound_by": e16_bfby if e16_bfby == e16_bbby else "operations",
         "f32_grade_bound_ms_fwd": e16_gf, "f32_grade_bound_ms_bwd": e16_gb,
         "library_ms": e16_lf + e16_lb, "library_ms_fwd": e16_lf, "library_ms_bwd": e16_lb,
         "bf16_gates": E_BF16_GATES, "readings": e_read16,
         "hmma_bf16": {k: n for k, n in e_mma.items() if "__nv_bfloat16" in k}},
        # G at a PPO update's 1500 rows, f32; no single PyTorch call computes
        # LN(h + FFN(h)); every shape at both dtypes beside
        {"name": "ffn_block", "route": "cuda", "source": f"{pkg}/csrc/ffn_block.cu",
         "replaces": f"{tpu}/ffn_block.py:187", "launches": sum(launches["G"]),
         "launches_fwd": launches["G"][0], "launches_bwd": launches["G"][1],
         "max_abs_err": g_err["update"], "ms": g32["ms_fwd"] + g32["ms_bwd"],
         "plain_ms": g32["plain_ms_fwd"] + g32["plain_ms_bwd"],
         "bound_ms": g32["bound_ms_fwd"] + g32["bound_ms_bwd"], "bound_by": g32["bound_by"],
         "library_ms": None, "hmma": dg_mma["ffn_block"],
         **{f"{tag}_shape": {**g_t[tag, torch.float32], "bf16": g_t[tag, torch.bfloat16]}
            for tag in ("update", "rollout", "pretrain")},
         "launches_pretrain": sum(launches["G_pretrain"]),
         "eager_calls_fwd": launches["G_eager"][0],
         "launches_rl_mesh": {ph: v for ph, v in rl_launches(4).items() if ph == "phase40b"},
         # phase 43 under RLMG_FFN_BACKEND=pallas: G's (fwd, bwd) on each stage
         "launches_pp": {f"phase{ph}": [r["g"]["counts"][8:10] for r in v["res"]]
                         for ph, v in pp_found.items() if ph != 44 and "g" in v["res"][0]},
         "ppo_rollout_song": {k: {kk: vv for kk, vv in v.items() if "window" not in kk}
                              | {"busy_graphed": v["window_graphed"]["busy"],
                                 "busy_eager": v["window_eager"]["busy"],
                                 "host_launches_graphed": v["window_graphed"]["host_launches"],
                                 "host_launches_eager": v["window_eager"]["host_launches"]}
                              for k, v in p_cmp.items()}},
    ] + lat_entries + aug_entries
    for e in kernels:                                        # v3's share of the SASS count
        if e["name"] == "decode_step_v3":                    # (v2's are the tanh gelu's)
            e["hmma"] = {k.split(":")[1][:60]: n for k, n in stack_mma.items()
                         if k.startswith("decode_aug") and "Lb1ELb1E" not in k}
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
