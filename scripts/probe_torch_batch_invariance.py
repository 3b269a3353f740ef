#!/usr/bin/env python3
"""Where a song decoded alone parts from the same song in a batch, on kernel
A's per-step path (``decode_kernel_v4.fused_stack_step``, the token kernel
of ``csrc/decode_stack_tc.cuh``), at ``config.agent_config`` (12 layers,
d_model 512, 8 heads, FFN 2048), random weights from seed 0, 16 tokens from
seed 1, the song in row 5 of a batch of 8 whose other rows take its first
token (as ``chip_smoke.slot_state_alone`` builds it).

    python3 scripts/probe_torch_batch_invariance.py

For f32 and bf16 layer weights (the embedding's f32 in both) it prints:
  * whether ``embed_input`` gives the song's row alike at B=1 and in the
    batch (the first token where it does not, and the largest difference);
  * whether the token kernel, fed the B=1 embedding row in row 5 of the
    batch, gives h, S and z alike at both batches over the 16 tokens (the
    first token where it does not);
  * the state's difference as a share of its magnitude along the path as
    ``slot_state_alone`` drives it (the embedding formed in each batch),
    and with the embedding formed a row at a time.
It prints the card's name and power limit first and one JSON line last.
Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from reinforcement_learning_in_music_generation_torch import config as C  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import tokenizer  # noqa: E402
from reinforcement_learning_in_music_generation_torch.models import (  # noqa: E402
    common as cm, linear_transformer as lt)
from reinforcement_learning_in_music_generation_torch.ops import (  # noqa: E402
    decode_kernel_v4 as dk4)

ROW, BATCH, TOKENS = 5, 8, 16


def share(a, b) -> float:
    return (a.float() - b.float()).abs().max().item() / max(1.0, b.float().abs().max().item())


def probe(params, cfg, dev, toks, wdt) -> dict:
    dpw = lt.make_decode_params(params, cfg, wdt)
    work = {b: dk4.workspace(dpw, b) for b in (1, BATCH)}
    pe = cm.sinusoidal_table(cfg.max_len, cfg.d_model, torch.float32, dev)
    feed = toks[0].expand(BATCH, -1).clone()
    st1, st8 = dk4.init_state(cfg, 1, device=dev), dk4.init_state(cfg, BATCH, device=dev)
    tag = str(wdt)[6:]
    res = {"embed_first_token_differing": None, "embed_max_abs_diff": 0.0,
           "kernel_first_token_differing": None}
    for pos in range(TOKENS):
        feed[ROW] = toks[pos]
        x8 = lt.embed_input(params, cfg, feed, pos, pe).float()
        x1 = lt.embed_input(params, cfg, toks[pos:pos + 1], pos, pe).float()
        if not torch.equal(x8[ROW], x1[0]):
            res["embed_max_abs_diff"] = max(res["embed_max_abs_diff"],
                                            (x8[ROW] - x1[0]).abs().max().item())
            if res["embed_first_token_differing"] is None:
                res["embed_first_token_differing"] = pos
        x8[ROW] = x1[0]                            # equal input rows for the kernel
        o1 = dk4.fused_stack_step(None, x1, st1.s, st1.z, n_head=cfg.n_head,
                                  work=work[1])[0].clone()
        o8 = dk4.fused_stack_step(None, x8, st8.s, st8.z, n_head=cfg.n_head,
                                  work=work[BATCH])[0].clone()
        same = (torch.equal(o1[0], o8[ROW]) and torch.equal(st1.s[:, 0], st8.s[:, ROW])
                and torch.equal(st1.z[:, 0], st8.z[:, ROW]))
        if not same and res["kernel_first_token_differing"] is None:
            res["kernel_first_token_differing"] = pos
    res["kernel_state_share_equal_inputs"] = max(share(st1.s[:, 0], st8.s[:, ROW]),
                                                 share(st1.z[:, 0], st8.z[:, ROW]))
    # the path as slot_state_alone drives it, then with the embedding a row at a time
    for key, rowwise in (("path_state_share", False), ("rowwise_embed_state_share", True)):
        st1, st8 = dk4.init_state(cfg, 1, device=dev), dk4.init_state(cfg, BATCH, device=dev)
        for pos in range(TOKENS):
            feed[ROW] = toks[pos]
            x8 = (torch.cat([lt.embed_input(params, cfg, feed[i:i + 1], pos, pe)
                             for i in range(BATCH)]) if rowwise
                  else lt.embed_input(params, cfg, feed, pos, pe)).float()
            x1 = lt.embed_input(params, cfg, toks[pos:pos + 1], pos, pe).float()
            dk4.fused_stack_step(None, x1, st1.s, st1.z, n_head=cfg.n_head, work=work[1])
            dk4.fused_stack_step(None, x8, st8.s, st8.z, n_head=cfg.n_head, work=work[BATCH])
        torch.cuda.synchronize()
        res[key] = max(share(st1.s[:, 0], st8.s[:, ROW]), share(st1.z[:, 0], st8.z[:, ROW]))
    print(f"[batch] {tag} layer weights, {str(st1.s.dtype)[6:]} state: {res}", flush=True)
    return res


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_torch_batch_invariance: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    e2w, _ = tokenizer.drop_type(tokenizer.construct_cp_dict())
    cfg = C.agent_config(tuple(tokenizer.n_classes(e2w)))
    params = lt.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    toks = torch.stack([torch.randint(0, v, (TOKENS,), generator=gen, device=dev)
                        for v in cfg.vocab_sizes], dim=-1).to(torch.int32)
    out = {str(w)[6:]: probe(params, cfg, dev, toks, w) for w in (torch.float32, torch.bfloat16)}
    print(json.dumps({"card": card, "row": ROW, "batch": BATCH, "tokens": TOKENS,
                      "by_weights": out}))


if __name__ == "__main__":
    main()
