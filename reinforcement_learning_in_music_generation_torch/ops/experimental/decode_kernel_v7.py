"""Latency-mode decode, one launch per layer: the counterpart of the JAX
package's ``ops/experimental/decode_kernel_v7.py`` (``fused_decode_v7``,
its Pallas body ``_v7_kernel``, grid (T, L)).

Kernel: ``csrc/latency_decode.cu``, the device functions of
``decode_kernel_v8`` under another launch structure: per token one
cooperative launch per layer (its four phases, three grid barriers inside;
layer 0 also forms the embedding), one for the heads product and one for
the sampling, L + 2 launches a token.  One token's launches are captured
once per shape as a CUDA graph (updated in place when a call's pointers or
settings change) and replayed T times; the token index lives on the card,
advanced by the heads launch.  Each launch is a programmatic dependent of
the one before, so it requests its weight tiles before it waits.  The
state lives in device memory, since shared memory does not outlive a
launch; the same functions in the same order give tokens and states
bit-equal to v8's, as the JAX test ``test_v8_matches_v7_greedy`` asks of
the TPU pair.

Plain twin: ``decode_kernel_v8.latency_decode_plain``, shared with v8.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..linear_attention import DEFAULT_EPS
from .decode_kernel_v8 import (ResidentParams, check_tok0, count, latency_decode_plain,
                               make_resident_params, reset, run_kernel)

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
    the calls, ``cuda_launches`` their (L + 2) T kernel launches,
    ``captures`` / ``updates`` the calls that instantiated or updated the
    token graph); CPU tensors to ``latency_decode_plain``."""
    nf = len(vocab_sizes)
    check_tok0(v7p, tok0, t0, max_tokens, nf)
    if tok0.device.type == "cpu":
        return latency_decode_plain(v7p, tok0, s, z, t0, seed, n_head=n_head,
                                    max_tokens=max_tokens, temps=temps, topps=topps,
                                    greedy=greedy, eps=eps)
    tokens, info = run_kernel(7, v7p, tok0, s, z, t0, seed, n_head=n_head,
                              max_tokens=max_tokens, vocab_sizes=vocab_sizes, temps=temps,
                              topps=topps, greedy=greedy, eps=eps)
    count(fused_decode_v7, info, max_tokens)
    return tokens, s, z


reset(fused_decode_v7)
