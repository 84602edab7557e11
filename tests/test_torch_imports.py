"""deepspeed_tpu_torch and chip_smoke.py stand alone: neither imports
jax, flax nor anything of deepspeed_tpu (the machine with the card has
no JAX). And the ctypes signatures of the CUDA library match its C
entry points (a mismatch shows only on the card otherwise)."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "deepspeed_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|deepspeed_tpu)(\.|\s|$)", re.M)


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_port_sources_import_no_jax():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"] \
        + sorted((REPO / "tests" / "perf").glob("torch_*.py"))
    bad = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
           for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert not bad, bad


def test_port_imports_with_jax_poisoned():
    """Every module of the port, and chip_smoke without running its
    main, import in a process where jax and deepspeed_tpu cannot; there
    the LLaMA training model takes a step through ``initialize``,
    ``llama_generate`` runs and the ZeRO-Infinity engine takes a step."""
    mods = _modules() + ["chip_smoke"]
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'deepspeed_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import torch\n"
            "import deepspeed_tpu_torch as dst\n"
            "from deepspeed_tpu_torch.models import llama\n"
            "model = llama.LlamaForCausalLM(llama.llama_tiny(remat=True,\n"
            "                                                loss_chunk=8))\n"
            "eng = dst.initialize(config={'train_batch_size': 2},\n"
            "                     model=model, device='cpu')[0]\n"
            "ids = torch.randint(0, 512, (2, 12))\n"
            "assert torch.isfinite(eng.train_batch({'input_ids': ids}))\n"
            "assert llama.llama_generate(model, ids, 3).shape == (2, 15)\n"
            "from deepspeed_tpu_torch.models import gpt2\n"
            "from deepspeed_tpu_torch.runtime.zero import infinity\n"
            "cfg = gpt2.gpt2_tiny(dtype=torch.float32)\n"
            "inf = infinity.InfinityEngine(\n"
            "    cfg, infinity.gpt2_client_init(cfg), device='cpu',\n"
            "    segments=2)\n"
            "assert inf.train_batch({'input_ids': ids}) > 0\n"
            "print('OK', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK")
    assert {"deepspeed_tpu_torch.models.llama",
            "deepspeed_tpu_torch.models.llama_inference",
            "deepspeed_tpu_torch.serving.adapters",
            "deepspeed_tpu_torch.runtime.zero.infinity"} <= set(mods)
    assert len(mods) >= 17


def test_ctypes_signatures_match_c_entry_points():
    import ctypes

    from deepspeed_tpu_torch.ops.cuda.builder import SIGNATURES
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    entry = re.compile(r'^(?:extern "C" )?int (dstpu_\w+)\(([^)]*)\)', re.M)
    found = {}
    for cu in sorted((PKG / "csrc").glob("*.cu")):
        for name, params in entry.findall(cu.read_text()):
            types = [re.sub(r"\s+\w+$", "", a.strip()).replace("const ", "")
                     .replace(" ", "") for a in params.split(",")]
            found[name] = [ctype[t] for t in types]
    assert found == SIGNATURES


def test_offload_tiers_run_with_jax_poisoned(tmp_path):
    """The offload modules, the native libraries' bindings and the
    swappers stand alone too: with jax and deepspeed_tpu poisoned, the
    streamed tier, the host runner with NVMe moments and the NVMe
    parameter tier each take a step, and a checkpoint round-trips."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'deepspeed_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import torch\n"
            "import deepspeed_tpu_torch as dst\n"
            "from deepspeed_tpu_torch.models import gpt2\n"
            f"nvme = {str(tmp_path)!r}\n"
            "tiers = [{'offload_optimizer': {'device': 'cpu'}},\n"
            "         {'offload_optimizer': {'device': 'nvme',\n"
            "                                'nvme_path': nvme}},\n"
            "         {'offload_optimizer': {'device': 'cpu',\n"
            "                                'stream': 'host'},\n"
            "          'offload_param': {'device': 'nvme',\n"
            "                            'nvme_path': nvme}}]\n"
            "ids = torch.randint(0, 512, (2, 12))\n"
            "for zero in tiers:\n"
            "    cfg = {'train_batch_size': 2, 'optimizer': {'type': 'cpuadam'},\n"
            "           'zero_optimization': dict(stage=2, **zero)}\n"
            "    model = gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny())\n"
            "    eng = dst.initialize(config=cfg, model=model, device='cpu')[0]\n"
            "    assert torch.isfinite(eng.train_batch({'input_ids': ids}))\n"
            "    eng.save_checkpoint(nvme + '/ckpt')\n"
            "    eng.load_checkpoint(nvme + '/ckpt')\n"
            "    assert torch.isfinite(eng.train_batch({'input_ids': ids}))\n"
            "    eng.close()\n"
            "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK")


def test_n_rank_stage2_step_and_checkpoint_run_with_jax_poisoned(tmp_path):
    """A gloo world of 2 ranks at ZeRO stage 2 (several buckets) takes
    its steps, saves per-rank checkpoints and resumes from them, with jax
    and deepspeed_tpu poisoned in the parent and in every rank."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'deepspeed_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import numpy as np, torch\n"
            "from deepspeed_tpu_torch.models import gpt2\n"
            "from deepspeed_tpu_torch.parallel.mesh import spawn\n"
            "import torch_zero_stages_worker as w\n"
            "kw = {'dtype': torch.float32}\n"
            "m = gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny(**kw), device='cpu')\n"
            "m.reset_parameters(torch.Generator().manual_seed(0))\n"
            "state = {k: v.detach().numpy() for k, v in\n"
            "         m.state_dict().items()}\n"
            "cfg = {'train_batch_size': 4, 'zero_optimization': {\n"
            "    'stage': 2, 'overlap_comm': True,\n"
            "    'reduce_bucket_size': 5000}}\n"
            "ids = [{'input_ids': np.random.RandomState(i).randint(\n"
            "    0, 512, (4, 8))} for i in range(3)]\n"
            f"d = {str(tmp_path)!r}\n"
            "out = spawn(w.poisoned_jobs, 2, [('save_and_resume', cfg,\n"
            "            state, ids[:2], ids[2], d, kw)])\n"
            "losses, want, got, files = out[0][0]\n"
            "assert all(np.isfinite(losses)) and got == want, out\n"
            "assert 'shard_index_1.json' in files, files\n"
            "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK")


def test_n_rank_stage3_gather_path_runs_with_jax_poisoned(tmp_path):
    """A gloo world of 2 ranks at ZeRO stage 3 on the gather path
    (stage3_prefetch off, several buckets) takes its steps, saves per-rank
    checkpoints and resumes from them, with jax and deepspeed_tpu
    poisoned in the parent and in every rank."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'deepspeed_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import numpy as np, torch\n"
            "from deepspeed_tpu_torch.models import gpt2\n"
            "from deepspeed_tpu_torch.parallel.mesh import spawn\n"
            "import torch_zero_stages_worker as w\n"
            "kw = {'dtype': torch.float32}\n"
            "m = gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny(**kw), device='cpu')\n"
            "m.reset_parameters(torch.Generator().manual_seed(0))\n"
            "state = {k: v.detach().numpy() for k, v in\n"
            "         m.state_dict().items()}\n"
            "cfg = {'train_batch_size': 4, 'zero_optimization': {\n"
            "    'stage': 3, 'reduce_bucket_size': 5000,\n"
            "    'stage3_param_persistence_threshold': 0}}\n"
            "ids = [{'input_ids': np.random.RandomState(i).randint(\n"
            "    0, 512, (4, 8))} for i in range(3)]\n"
            f"d = {str(tmp_path)!r}\n"
            "out = spawn(w.poisoned_jobs, 2, [('save_and_resume', cfg,\n"
            "            state, ids[:2], ids[2], d, kw)])\n"
            "losses, want, got, files = out[0][0]\n"
            "assert all(np.isfinite(losses)) and got == want, out\n"
            "assert 'shard_index_1.json' in files, files\n"
            "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), \
        proc.stdout + proc.stderr


def test_n_rank_offload_step_and_checkpoint_run_with_jax_poisoned(tmp_path):
    """A gloo world of 2 ranks at ZeRO stage 2 with the optimizer state on
    the host (the streamed tier) and with NVMe moments (the host runner)
    takes its steps, saves per-rank checkpoints and resumes from them,
    with jax and deepspeed_tpu poisoned in the parent and in every
    rank."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'deepspeed_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import numpy as np, torch\n"
            "from deepspeed_tpu_torch.models import gpt2\n"
            "from deepspeed_tpu_torch.parallel.mesh import spawn\n"
            "import torch_zero_offload_worker as w\n"
            "kw = {'dtype': torch.float32}\n"
            "m = gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny(**kw), device='cpu')\n"
            "m.reset_parameters(torch.Generator().manual_seed(0))\n"
            "state = {k: v.detach().numpy() for k, v in\n"
            "         m.state_dict().items()}\n"
            f"d = {str(tmp_path)!r}\n"
            "def cfg(offload):\n"
            "    return {'train_batch_size': 4, 'zero_optimization': {\n"
            "        'stage': 2, 'reduce_bucket_size': 5000,\n"
            "        'offload_optimizer': offload}}\n"
            "ids = [{'input_ids': np.random.RandomState(i).randint(\n"
            "    0, 512, (4, 8))} for i in range(3)]\n"
            "nvme = {'device': 'nvme', 'nvme_path': d + '/nvme'}\n"
            "out = spawn(w.poisoned_jobs, 2, [\n"
            "    ('save_and_resume', cfg({'device': 'cpu'}), state, ids[:2],\n"
            "     ids[2], d + '/ckpt', kw),\n"
            "    ('save_and_resume', cfg(nvme), state, ids[:2], ids[2],\n"
            "     d + '/ckpt_nvme', kw)])\n"
            "for losses, want, got, files in out[0]:\n"
            "    assert all(np.isfinite(losses)) and got == want, out\n"
            "    assert 'shard_index_1.json' in files, files\n"
            "print('OK')\n")
    os.makedirs(tmp_path / "nvme")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK")


def test_native_ctypes_signatures_match_c_entry_points():
    """Every C entry point of csrc/cpu_adam.cpp and csrc/aio.cpp that the
    bindings call has argtypes of its parameters' count and kinds."""
    import ctypes

    from deepspeed_tpu_torch.ops.native import aio, cpu_adam
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_char_p: "ptr",
             ctypes.c_int64: "i64", ctypes.c_int: "int",
             ctypes.c_float: "float"}
    libs = {"cpu_adam.cpp": cpu_adam.load().lib, "aio.cpp": aio.load()}
    entry = re.compile(r"^\w[\w\s\*]*?\b((?:ds|aio)_\w+)\(([^)]*)\)\s*\{",
                       re.M)
    checked = 0
    for src, lib in libs.items():
        text = (PKG / "csrc" / src).read_text()
        for name, params in entry.findall(text):
            fn = getattr(lib, name)
            if fn.argtypes is None:
                continue
            want = []
            for a in re.sub(r"//[^\n]*", "", params).split(","):
                a = a.strip()
                if not a:
                    continue
                want.append("ptr" if "*" in a else
                            {"int64_t": "i64", "int": "int",
                             "float": "float"}[a.replace("const ", "")
                                               .split()[0]])
            assert [kinds[t] for t in fn.argtypes] == want, name
            checked += 1
    assert checked >= 15
