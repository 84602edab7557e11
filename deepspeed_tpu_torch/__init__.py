"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu`` for
one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``deepspeed_tpu`` is the reference this package is held
against; this package imports nothing of it. Every Pallas kernel on a
ported path is a hand-written CUDA kernel here (``csrc/*.cu``, wrapped in
``ops/cuda/``), each beside its plain PyTorch version. Entry points run
on the card unless the caller passes ``device="cpu"``.

Ported so far: GPT-2 paged serving (``serving.build_engine``),
single-device training (``initialize`` → ``engine.train_batch``), with
the ZeRO-Offload tiers and, for ``offload_param.stream_segments > 0``,
the ZeRO-Infinity engine (``runtime/zero/infinity.py``), and ZeRO stages
0-3 over n ranks (``initialize(mesh=...)``)::

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_large

    engine, _, _, _ = ds.initialize(config=ds_config,
                                    model=GPT2LMHeadModel(gpt2_large()))
    loss = engine.train_batch({"input_ids": ids})
"""

__version__ = "0.2.0"


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mesh=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, rng=None, loss_fn=None, device=None):
    """Build the engine — mirrors ``deepspeed_tpu.initialize``
    (``deepspeed_tpu/__init__.py:70``) and returns the same 4-tuple
    ``(engine, optimizer, training_dataloader, lr_scheduler)``.

    ``model`` is a ``torch.nn.Module``; made on the meta device (the
    default of ``models.gpt2.GPT2LMHeadModel``) it is initialized by the
    engine from the config's seed (or ``rng``, an int seed).
    ``model_parameters`` is an optional state dict. ``optimizer`` is an
    optional port optimizer (``ops.adam.FusedAdam``) overriding the
    config's; ``lr_scheduler`` an optional schedule ``step -> lr``.
    ``device`` is where the engine runs: ``None`` means cuda and raises
    without a card, ``"cpu"`` runs the plain versions of the kernels.
    ``mesh`` is a ``parallel.mesh.Mesh`` (``make_mesh(MeshConfig(data=n))``
    in each of n processes of a ``torch.distributed`` gloo group): at
    n > 1 the engine runs ZeRO stages 0-2 on the bucket stream and stage
    3 on the prefetch pipeline or the gather path (``engine.zero3_path``),
    each rank on the mesh's device. ``mpu`` (a model-parallel unit) is
    not ported.
    A config with ``zero_optimization.offload_param.stream_segments > 0``
    gives the ZeRO-Infinity engine (``runtime/zero/infinity.py``) and
    ``(engine, None, None, None)``, as JAX's ``initialize`` does;
    ``model_parameters`` is then the JAX tree (or a state dict)."""
    from deepspeed_tpu_torch.config.config import ROADMAP_MULTI_RANK
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError(
            "DeepSpeed requires --deepspeed_config to specify configuration "
            "file")
    segments = _stream_segments(config)
    if segments:
        # the ZeRO-Infinity segment-streamed engine (JAX __init__.py:
        # 126-159): it builds its Adam step and tied-LM loss itself
        unsupported = {
            "optimizer": optimizer, "training_data": training_data,
            "lr_scheduler": lr_scheduler, "mpu": mpu,
            "collate_fn": collate_fn, "loss_fn": loss_fn}
        bad = [k for k, v in unsupported.items() if v is not None]
        if bad:
            raise ValueError(
                "offload_param.stream_segments selects the ZeRO-Infinity "
                f"segment-streamed engine, which does not accept {bad}; "
                "it builds its Adam/AdamW step and tied-LM loss from the "
                "config (runtime/zero/infinity.py)")
        if mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                f"the ZeRO-Infinity engine runs on one rank "
                f"({ROADMAP_MULTI_RANK})")
        from deepspeed_tpu_torch.config.config import DeepSpeedConfig
        from deepspeed_tpu_torch.runtime.zero.infinity import \
            InfinityEngine
        parsed = config if isinstance(config, DeepSpeedConfig) \
            else DeepSpeedConfig(config)
        engine = InfinityEngine.from_config(
            model, parsed, model_parameters=model_parameters,
            device=device)
        return engine, engine.optimizer, engine.training_dataloader, \
            engine.lr_scheduler
    if mpu is not None:
        raise NotImplementedError(
            f"initialize(mpu=...): model parallelism is not ported; the "
            f"port trains on one rank or over a data mesh "
            f"({ROADMAP_MULTI_RANK})")
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler, collate_fn=collate_fn,
                             config=config, loss_fn=loss_fn, device=device,
                             seed=rng, mesh=mesh)
    return engine, engine.optimizer, engine.training_dataloader, \
        engine.lr_scheduler


def _stream_segments(config):
    """``offload_param.stream_segments`` of the raw config (a path, a
    dict or a parsed config), read before a full parse, as JAX's
    ``initialize`` does."""
    from deepspeed_tpu_torch.config.config import (DeepSpeedConfig,
                                                   load_param_dict)
    if isinstance(config, DeepSpeedConfig):
        return config.zero_config.offload_param.stream_segments
    zero = load_param_dict(config).get("zero_optimization", {})
    if not isinstance(zero, dict):
        return 0
    return int((zero.get("offload_param") or {}).get("stream_segments", 0)
               or 0)
