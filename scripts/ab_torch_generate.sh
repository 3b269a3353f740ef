#!/bin/bash
# Two checkouts of the repo, A and B, held against each other on one card:
# `cli generate` (8 bars, --warmup) at 128 songs (the chunked path) with
# bf16 weights (its default) and with f32 weights, 5 songs (the per-step
# path) with bf16 and f32 weights and 5 songs under RLMG_LATENCY_DECODE=1
# (the latency path, v8), f32 weights, then ms a token of the kernels v8
# and v7 (32-token calls, CP
# sampling) and of kernel A's layer stack at B = 1, 5 and 16, and ms a
# 128-token call of kernel B with bf16 weights at B = 128 and 1024
# (agent_config width, random bf16 weights and state, CUDA events after a
# warm call), in turns A, B, B, A, twice, so that neither side always runs
# first.  Prints the card and one line per run.  With a third argument
# `latency`, the generate runs are instead 1 and 5 songs on the latency
# path with its default bf16 weights, on v8 and (RLMG_LATENCY_KERNEL=v7)
# on v7.  With `cold`, they are 5 songs on the per-step path with bf16 and
# f32 weights, each first as a process's only call (no --warmup: the call
# pays the first call's set-up, a token graph's capture included) and then
# with --warmup, and the kernel times are left out.  With `f32`, kernel B
# with f32 weights alone: `cli generate --dtype float32` at 128 songs
# (tokens/s, --warmup) and ms a 128-token call at B = 128 and 1024 (f32
# weights, bf16 state, CP sampling, CUDA events after a warm call).
# AB_REPS (default 2) sets the rounds of A, B, B, A.
#
#   bash scripts/ab_torch_generate.sh <checkout A> <checkout B> [latency|cold|f32]
#
# Each checkout builds its own kernels into its build/torch_kernels/.
set -u
a=$1
b=$2
mode=${3:-all}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # checkout songs max_tokens dtype [latency [kernel [cold]]]
  local warm=--warmup
  [ "${7:-}" = cold ] && warm=
  (cd "$1" && RLMG_LATENCY_DECODE=${5:-0} RLMG_LATENCY_KERNEL=${6:-v8} \
     python -m reinforcement_learning_in_music_generation_torch.apps.cli generate \
     --songs "$2" --bars 8 --max-tokens "$3" --dtype "$4" $warm \
     --out-dir "${TMPDIR:-/tmp}/ab_generate/m" 2>&1 | grep "ave token time" \
     | sed "s|^|$1 songs=$2 $4 latency=${5:-0} ${6:-} ${7:-warm}: |")
}
chunk_f32() {  # checkout: kernel B with f32 weights, ms a 128-token call
  (cd "$1" && python3 - <<'EOF' | sed "s|^|$1 ms a call: |"
import torch
from reinforcement_learning_in_music_generation_torch import config as C
from reinforcement_learning_in_music_generation_torch.data import tokenizer
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as lt
from reinforcement_learning_in_music_generation_torch.ops import (
    decode_kernel_v4 as dk4, decode_kernel_v6 as dk6, sampling as smp)

e2w, _ = tokenizer.drop_type(tokenizer.construct_cp_dict())
cfg = C.agent_config(tuple(tokenizer.n_classes(e2w)))
params = lt.init_params(cfg, seed=0, device="cuda")
v6p = dk6.make_v6_params(params, cfg, dtype=torch.float32)
kw = dict(n_head=cfg.n_head, vocab_sizes=cfg.vocab_sizes, greedy=False, eps=cfg.attn_eps,
          temps=tuple(s.temperature for s in smp.CP_SAMPLING),
          topps=tuple(s.top_p if s.top_p is not None else float("inf") for s in smp.CP_SAMPLING))
out = []
for b in (128, 1024):
    tok = torch.zeros((b, 6), dtype=torch.int32, device="cuda")
    st = dk4.init_state(cfg, b, torch.bfloat16, "cuda")
    call = lambda: dk6.fused_decode_v6(v6p, tok, st.s, st.z, 0, 1, max_tokens=128, **kw)
    call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(2):
        call()
    end.record()
    end.synchronize()
    out.append(f"B-f32 B={b} {start.elapsed_time(end) / 2:.3f} ms a call")
    del st
print(" | ".join(out))
EOF
  )
}
per_token() {  # checkout: the package is imported from it (python's cwd)
  (cd "$1" && python3 - <<'EOF' | sed "s|^|$1 ms a token: |"
import torch
from reinforcement_learning_in_music_generation_torch import config as C
from reinforcement_learning_in_music_generation_torch.data import tokenizer
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as lt
from reinforcement_learning_in_music_generation_torch.ops import (
    decode_kernel_v4 as dk4, decode_kernel_v6 as dk6, sampling as smp)
from reinforcement_learning_in_music_generation_torch.ops.experimental import (
    decode_kernel_v7 as dk7, decode_kernel_v8 as dk8)


def time_ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


e2w, _ = tokenizer.drop_type(tokenizer.construct_cp_dict())
cfg = C.agent_config(tuple(tokenizer.n_classes(e2w)))
params = lt.init_params(cfg, seed=0, device="cuda")
rp = dk8.make_resident_params(params, cfg, dtype=torch.bfloat16)
dp = lt.make_decode_params(params, cfg, torch.bfloat16)
kw = dict(n_head=cfg.n_head, vocab_sizes=cfg.vocab_sizes, greedy=False, eps=cfg.attn_eps,
          temps=tuple(s.temperature for s in smp.CP_SAMPLING),
          topps=tuple(s.top_p if s.top_p is not None else float("inf") for s in smp.CP_SAMPLING))
out = []
for b in (1, 5, 16):
    tok = torch.zeros((b, 6), dtype=torch.int32, device="cuda")
    st = dk4.init_state(cfg, b, torch.bfloat16, "cuda")
    v8 = time_ms(lambda: dk8.fused_decode_v8(rp, tok, st.s, st.z, 0, 1, max_tokens=32, **kw), 10)
    v7 = time_ms(lambda: dk7.fused_decode_v7(rp, tok, st.s, st.z, 0, 1, max_tokens=32, **kw), 5)
    h = torch.zeros((b, cfg.d_model), device="cuda")
    # a checkout whose kernel A takes a caller-held workspace gets one
    kw_a = {"work": dk4.workspace(dp, b)} if hasattr(dk4, "StackWorkspace") else {}
    a = time_ms(lambda: dk4.fused_stack_step(dp, h, st.s, st.z, n_head=cfg.n_head, **kw_a), 30)
    out.append(f"B={b} v8 {v8 / 32:.4f} v7 {v7 / 32:.4f} A {a:.4f}")
v6p = dk6.make_v6_params(params, cfg, dtype=torch.bfloat16)
for b in (128, 1024):
    tok = torch.zeros((b, 6), dtype=torch.int32, device="cuda")
    st = dk4.init_state(cfg, b, torch.bfloat16, "cuda")
    ms = time_ms(lambda: dk6.fused_decode_v6(v6p, tok, st.s, st.z, 0, 1, max_tokens=128, **kw), 2)
    out.append(f"B-bf16 B={b} {ms:.3f} ms a call")
print(" | ".join(out))
EOF
  )
}
for rep in $(seq "${AB_REPS:-2}"); do
  for tree in "$a" "$b" "$b" "$a"; do
    if [ "$mode" = f32 ]; then
      run "$tree" 128 256 float32
      chunk_f32 "$tree"
      continue
    elif [ "$mode" = cold ]; then
      for dtype in bfloat16 float32; do
        run "$tree" 5 512 "$dtype" 0 v8 cold
        run "$tree" 5 512 "$dtype"
      done
      continue
    elif [ "$mode" = latency ]; then
      for songs in 1 5; do
        run "$tree" "$songs" 512 bfloat16 1 v8
        run "$tree" "$songs" 512 bfloat16 1 v7
      done
    else
      run "$tree" 128 256 bfloat16
      run "$tree" 128 256 float32
      run "$tree" 5 512 bfloat16
      run "$tree" 5 512 float32
      run "$tree" 5 512 float32 1
    fi
    per_token "$tree"
  done
done
