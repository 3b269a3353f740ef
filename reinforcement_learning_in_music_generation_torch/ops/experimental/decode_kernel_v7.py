"""Latency-mode decode, one launch per layer: the counterpart of the JAX
package's ``ops/experimental/decode_kernel_v7.py`` (``fused_decode_v7``,
its Pallas body ``_v7_kernel``, grid (T, L)).

Kernel: ``csrc/latency_decode.cu``, the device functions of
``decode_kernel_v8`` under another launch structure: per token one launch
for the embedding, one cooperative launch per layer and one for the heads +
sample pass, L + 2 launches a token, the loop over T in C as kernel B's.
The state lives in device memory, since shared memory does not outlive a
launch; the same functions in the same order give tokens and states
bit-equal to v8's, as the JAX test ``test_v8_matches_v7_greedy`` asks of
the TPU pair.

Plain twin: ``decode_kernel_v6.chunk_decode_v4_plain``, shared with v8.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..decode_kernel_v6 import chunk_decode_v4_plain
from ..linear_attention import DEFAULT_EPS
from .decode_kernel_v8 import (ResidentParams, check_tok0, count, make_resident_params, reset,
                               run_kernel)

V7Params = ResidentParams
make_v7_params = make_resident_params


def fused_decode_v7(v7p: V7Params, tok0: torch.Tensor, s: torch.Tensor, z: torch.Tensor,
                    t0: int, seed: int, *, n_head: int, max_tokens: int,
                    vocab_sizes: Sequence[int], temps: Sequence[float],
                    topps: Sequence[float], greedy: bool = False,
                    eps: float = DEFAULT_EPS):
    """``fused_decode_v8``'s contract, L + 2 launches a token: tok0 (B, NF)
    int32 is fed at t0, s/z are updated in place, returns (tokens (T, B,
    NF) int32, s, z).  CUDA tensors go to the kernel (``launches`` counts
    the calls, ``cuda_launches`` their (L + 2) T launches); CPU tensors to
    ``chunk_decode_v4_plain``."""
    nf = len(vocab_sizes)
    check_tok0(v7p, tok0, t0, max_tokens, nf)
    if tok0.device.type == "cpu":
        return chunk_decode_v4_plain(v7p, tok0, s, z, t0, seed, n_head=n_head,
                                     max_tokens=max_tokens, temps=temps, topps=topps,
                                     greedy=greedy, eps=eps)
    tokens, n = run_kernel(7, v7p, tok0, s, z, t0, seed, n_head=n_head, max_tokens=max_tokens,
                           vocab_sizes=vocab_sizes, temps=temps, topps=topps, greedy=greedy,
                           eps=eps)
    count(fused_decode_v7, n, max_tokens)
    return tokens, s, z


reset(fused_decode_v7)
