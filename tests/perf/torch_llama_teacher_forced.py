"""Where a LLaMA-7B paged serve's tokens part from a dense forward.

    python3 tests/perf/torch_llama_teacher_forced.py [--layers N]
        [--std S] [--plain]

Serves chip_smoke.py's 16 greedy requests (the same draw) through LLaMA-7B (random
weights from seed 0, 8 slots) on one GPU through the CUDA kernels and,
with ``--plain``, again through the kernels' plain versions (the
adapter's kernel calls swapped for them). Every generated position of
each run is then held
against two dense forwards of the same tokens (``dense_logits``): in
bf16, and in fp32 with the same weights upcast layer by layer (chip_smoke's
teacher-forced oracle for LLaMA). Prints one JSON line per run with, against each dense
forward, the largest and median gap of the run's token below the dense
maximum (in units of the bf16 last place of that maximum) and how many
positions took another token than the dense argmax. If the plain-version
engine parts from the bf16 dense forward as far as the kernel engine
does, the gap is the arithmetic's (bf16 rounding of a paged decode
against a dense pass), not the kernels'.
"""

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import chip_smoke  # noqa: E402


def gaps(res, oracle):
    """(gap in bf16 units of the oracle's top logit, differs from the
    oracle's argmax) at every generated position."""
    units, differs = [], []
    for rid in sorted(res):
        r = res[rid]
        toks = r.tokens()
        S = len(r.prompt)
        rows = oracle(toks[:-1])[S - 1:].float()
        gen = torch.as_tensor(toks[S:], device=rows.device).long()
        top = rows.max(-1).values
        gap = top - rows.gather(1, gen[:, None])[:, 0]
        ulp = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(1e-30)))
                         - 7)
        units.append(gap / ulp)
        differs.append(rows.argmax(-1) != gen)
    u, d = torch.cat(units), torch.cat(differs)
    return {"max_units": float(u.max()), "median_units": float(u.median()),
            "positions": int(u.numel()), "not_argmax": int(d.sum()),
            "over_3_units": int((u > 3).sum())}


def main():
    import numpy as np
    import deepspeed_tpu_torch.serving as serving
    from deepspeed_tpu_torch.models.llama import llama_7b
    from deepspeed_tpu_torch.models.llama_inference import (
        dense_logits, init_serving_params)
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.serving import adapters
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--std", type=float, default=0.02,
                    help="std of every matrix and embedding (default: "
                         "0.02, the flax init; chip_smoke serves at "
                         "LLAMA_INIT_STD)")
    ap.add_argument("--plain", action="store_true",
                    help="also serve through the plain versions")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cfg = dataclasses.replace(llama_7b(), n_layers=args.layers)
    eng = serving.build_engine(
        "llama", cfg, init_serving_params(cfg, seed=0, device="cuda",
                                          std=args.std),
        config={"serving": chip_smoke.SERVING})
    p = eng.adapter.p
    oracles = {"bf16_dense": lambda ids: dense_logits(p, cfg, ids),
               "fp32_dense": lambda ids: dense_logits(p, cfg, ids,
                                                      torch.float32)}
    plain = {"ln_qkv_stacked": dk.ln_qkv_stacked_plain,
             "matvec_stacked": dk.matvec_stacked_plain,
             "out_ffn_stacked": dk.out_ffn_stacked_plain,
             "decode_attention_paged": dk.decode_attention_paged_plain}

    def plain_attention(q, k, v, causal=False):
        return fa.flash_attention_fwd_plain(q, k, v, causal=causal)[0]

    for run in ("kernels", "plain") if args.plain else ("kernels",):
        if run == "plain":
            for name, fn in plain.items():
                setattr(adapters, name, fn)
            adapters.dot_product_attention = plain_attention
        main_b = serving.ContinuousBatcher(eng.adapter)
        rs = np.random.RandomState(0)
        rs.randint(0, cfg.vocab_size, 40)   # chip_smoke's warm-up prompt
        res = main_b.serve(chip_smoke.traffic(cfg, rs))
        line = {"run": run, "layers": cfg.n_layers,
                "std": args.std,
                "device": torch.cuda.get_device_name(0)}
        for name, oracle in oracles.items():
            line[name] = gaps(res, oracle)
        if run == "kernels":
            toks_k = {r: res[r].tokens() for r in res}
        else:
            line["tokens_equal_to_kernel_run"] = sum(
                int(np.array_equal(toks_k[r], res[r].tokens())) for r in res)
        print(json.dumps(line), flush=True)
        del main_b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
