#!/usr/bin/env bash
# A/B comparison of two trees of the PyTorch port on one card, in one call:
# chip_smoke.py runs from the old tree, this tree, this tree again (with
# --profile) and the old tree again (with --profile), so that drift of the
# card or the host shows on both sides and each tree has one profiled run
# (the host's share of a decode step). Each run's output goes to
# chiprun_out/ab_*.log; a
# summary is printed per run: the flash and decode-projection kernel lines
# (ln_qkv*, out_ffn*, matvec*: slots, weights, bound and the torch.matmul
# yardstick; the variants a row carries: other_turns_us, fma_us), the flash
# backward lines (the old tree's two kernels, this tree's kernel, delta
# and whole backward, beside SDPA's backward), the train line (the GPT-2
# large step), the grad check, the serve lines' decode ms a step and the
# fast path's t(4 new) and decode ms a step by batch, GPT-2's generate()
# cases' decode ms a step, the profiled runs' idle share and host time
# by path, the ZeRO-3 lines (step, barriers a step and their host time,
# mm_rs_reduce's kernel line), the decode-attention (with the folded
# append's cost where the tree has it)
# and block-sparse kernel lines (the forward, dq and dk/dv, with a decode
# row's split plan and a block-sparse row's work list), the decode pos
# sweeps and the BERT sparse step, the quantize kernel lines and the MoQ
# train lines (step, each boundary's device and host time);
# then tests/perf/torch_llama_t4.py and torch_kernel_rows.py --decode --bs
# from each tree in turns (whole lines in chiprun_out/ab_t4_N.log and
# ab_rows_N.log), or with `moq` tests/perf/torch_moq_boundary.py
# (ab_moq_N.log), and the GPU unit tests of this tree (the fused
# collective's start two ranks on the card).
#
#   bash tests/perf/torch_ab_compare.sh OLD_TREE [moq]
#
# OLD_TREE is a directory inside this tree that .gitignore lists (e.g.
# build/pre_change), holding `git archive` of the commit to compare with.
set -u
old=${1:?usage: torch_ab_compare.sh OLD_TREE [moq]}
turns=${2:-decode}
here=$(pwd)
mkdir -p chiprun_out
summ() {
  python3 - "$1" <<'PY'
import json, sys
name = sys.argv[1]
ok = False
for line in open(name):
    line = line.strip()
    if not line.startswith("{"):
        continue
    try:
        d = json.loads(line)
    except ValueError:
        continue
    if d.get("phase") == "kernel" and (
            "flash" in d["name"] or d["name"].startswith((
                "matvec", "ln_qkv", "out_ffn", "decode_attention",
                "blocksparse", "mm_rs", "kv_quant"))):
        more = "".join(" %s=%.2f" % (k, d[k]) for k in
                       ("other_turns_us", "fma_us", "library_us",
                        "matmul_us", "bound_us", "no_fold_us",
                        "fold_cost_us", "pct_of_bound")
                       if d.get(k) is not None)
        if d["name"].startswith(("matvec", "ln_qkv", "out_ffn")):
            more += " B=%s %s" % (
                "/".join(str(c.get("B")) for c in d.get("cases", [])),
                (d.get("cases") or [{}])[0].get("weights", "bf16"))
        more += "".join(" %s=%s" % (k, d[k]) for k in
                        ("n_split", "chunk", "tiles", "steps")
                        if k in d)
        print(name, d["name"], d.get("path", ""),
              "kernel_us=%.2f call_us=%.2f rel=%.3g fault=%.3g%s"
              % (d["kernel_us"], d["call_us"], d["row_rel_err"],
                 d["fault_row_rel_err"], more))
        for c in d.get("cases", []):
            if "kernel_us" in c:
                print(name, d["name"], "S=%s" % c.get("S"),
                      "kernel_us=%.2f library_us=%.2f" % (
                          c["kernel_us"], c["library_us"]))
    if d.get("phase") in ("serve", "serve_llama", "serve_llama_int8",
                          "serve_gpt2_int8"):
        print(name, d["phase"], "decode_ms_per_step=%.3f"
              % d["ms_per_decode_step"])
    if d.get("phase") == "generate_gpt2":
        for c in d["cases"]:
            print(name, "generate_gpt2", c["case"],
                  "decode_ms_per_step=%.3f" % c["ms_per_decode_step"])
    if d.get("phase") == "generate_llama_int8":
        for c in d["cases"]:
            print(name, "generate_llama_int8 b%d" % c["batch"],
                  "t4_ms=%s decode_ms_per_step=%.3f"
                  % ("%.2f" % c["t4_ms"] if "t4_ms" in c else "n/a",
                     c["ms_per_decode_step"]))
    if d.get("phase") == "flash_backward":
        print(name, "flash_backward", d.get("path"), "S=%s D=%s" % (
                  d.get("S"), d.get("D", 64)),
              " ".join("%s=%.2f" % (k, d[k]) for k in (
                  "kernels_us", "kernel_us", "delta_us",
                  "delta_expression_us", "whole_backward_us", "bound_us",
                  "sdpa_backward_us", "sdpa_backward_graph_us")
                  if d.get(k) is not None))
    if d.get("phase") == "train":
        print(name, "train step_ms=%.2f mfu=%.4f peak=%.2f"
              % (d["step_ms"], d["mfu"], d["peak_memory_gb"]))
    if d.get("phase") == "kernel" and d["name"] == "quantize":
        t = d.get("kernel_us")
        print(name, "quantize", d["path"], d["case"],
              ("kernel_us=%.2f" % t) if t is not None else
              "kernel_ms=%.4f" % d["kernel_ms"],
              "pct_of_bound=%.1f" % d["pct_of_bound"],
              " ".join("%s=%.4g" % (k, d[k]) for k in (
                  "call_us", "call_ms", "copy_ms", "host_us_median",
                  "launches_a_boundary") if d.get(k) is not None))
    if d.get("phase") in ("train_moq", "train_moq_sr"):
        ms = d["boundary_device_ms"]
        print(name, d["phase"], "step_ms=%.2f" % d["step_ms"],
              "boundary_device_ms median=%.4f min=%.4f max=%.4f" % (
                  sorted(ms)[len(ms) // 2], min(ms), max(ms)),
              "host_us_median=%s" % d.get("boundary_host_us_median"),
              "launches_a_step=%s" % d["quantize_launches_a_step"][-1])
    if d.get("phase") == "train_bert_sparse":
        print(name, "train_bert_sparse step_ms=%.2f tokens_per_s=%.0f"
              % (d["step_ms"], d["tokens_per_s"]))
    if d.get("phase") == "bert_kernels":
        print(name, "bert_kernels sparse_fwd_bwd_us=%.1f"
              % d["sparse_fwd_bwd_us"])
    if d.get("phase") == "decode_pos_sweep":
        print(name, "decode_pos_sweep", d["model"], "max_rel=%.3g" % max(
            c["row_rel_err_max"] for c in d["cases"]))
    if d.get("phase") == "grad_check":
        print(name, "grad_check", d["max_row_rel_err"])
    if d.get("phase") in ("train_zero3_fused", "train_zero3_ring"):
        print(name, d["phase"], "step_ms=%.2f" % d["step_ms"],
              "barriers_per_step=%s" % d["barriers_per_step"],
              "barrier_wall_ms_per_step=%.2f" % d["barrier_wall_ms_per_step"],
              "mm_rs_reduce_a_step=%s" % d[
                  "launches_per_step_per_rank"].get("mm_rs_reduce"))
    if d.get("phase") == "profile":
        print(name, "profile", d["model"], "wall_s=%.4f busy_s=%.4f "
              "idle=%.4f tick_steps=%d" % (
                  d["wall_s"], d["device_busy_s"], d["device_idle_share"],
                  d["tick_steps"]))
    if d.get("phase") == "host_profile":
        print(name, "host_profile", d["model"], "wall_s=%.4f tick_steps=%d"
              % (d["wall_s"], d["tick_steps"]))
    if d.get("phase") == "generate_llama_int8":
        for k in ("profile_b1", "profile_b8"):
            if k in d:
                print(name, "generate_llama_int8", k, json.dumps(d[k]))
    if d.get("phase") == "kv_quant_int8_launches":
        print(name, "kv_quant_int8_launches", d["by_path"])
    if d.get("ok"):
        ok = True
print(name, "ok" if ok else "FAILED")
PY
}
(cd "$old" && python3 chip_smoke.py > "$here/chiprun_out/ab_old1.log" 2>&1)
summ chiprun_out/ab_old1.log
python3 chip_smoke.py > chiprun_out/ab_new1.log 2>&1
summ chiprun_out/ab_new1.log
python3 chip_smoke.py --profile > chiprun_out/ab_new2.log 2>&1
summ chiprun_out/ab_new2.log
(cd "$old" && python3 chip_smoke.py --profile \
   > "$here/chiprun_out/ab_old2.log" 2>&1)
summ chiprun_out/ab_old2.log
# the fast path's t(4 new) and decode ms a step at b8 and b1, which the old
# tree's chip_smoke may not print, and the decode-attention and block-
# sparse dk/dv rows of tests/perf/torch_kernel_rows.py with each tree's
# kernels: old, this, this, old
turn=0
for tree in "$old" "$here" "$here" "$old"; do
  turn=$((turn + 1))
  if [ "$turns" = moq ]; then
    python3 tests/perf/torch_moq_boundary.py --tree "$tree" \
      > chiprun_out/ab_moq_$turn.log 2>&1
    cut -c1-400 chiprun_out/ab_moq_$turn.log
    continue
  fi
  python3 tests/perf/torch_llama_t4.py --tree "$tree" \
    > chiprun_out/ab_t4_$turn.log 2>&1
  tail -2 chiprun_out/ab_t4_$turn.log
  python3 tests/perf/torch_kernel_rows.py --decode --bs --tree "$tree" \
    2>&1 | grep '^{' | sed "s|^|$tree |" > chiprun_out/ab_rows_$turn.log
  cut -c1-200 chiprun_out/ab_rows_$turn.log
done
python3 -m pytest --noconftest -p no:cacheprovider -m gpu \
  tests/test_torch_flash_backward.py tests/test_torch_flash_attention.py \
  tests/test_torch_decode_kernels.py tests/test_torch_llama_kernels.py \
  tests/test_torch_llama_int8.py tests/test_torch_gpt2_inference.py \
  tests/test_torch_sparse_attention.py tests/test_torch_bert.py \
  tests/test_torch_quantize.py tests/test_torch_fused_collective.py -q \
  2>&1 | tail -3
