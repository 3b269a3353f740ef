#!/bin/bash
# Two checkouts of the repo, A and B, held against each other on one card:
# `cli generate` (8 bars, f32 weights, --warmup) at 128 songs (the chunked
# path) and 5 songs (the per-step path), in turns A, B, B, A, twice, so
# that neither side always runs first.  Prints the card and one
# tokens/s line per run.
#
#   bash scripts/ab_torch_generate.sh <checkout A> <checkout B>
#
# Each checkout builds its own kernels into its build/torch_kernels/.
set -u
a=$1
b=$2
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # checkout songs max_tokens
  (cd "$1" && python -m reinforcement_learning_in_music_generation_torch.apps.cli generate \
     --songs "$2" --bars 8 --max-tokens "$3" --dtype float32 --warmup \
     --out-dir "${TMPDIR:-/tmp}/ab_generate/m" 2>&1 | grep "ave token time" \
     | sed "s|^|$1 songs=$2: |")
}
for rep in 1 2; do
  for tree in "$a" "$b" "$b" "$a"; do
    run "$tree" 128 256
    run "$tree" 5 512
  done
done
