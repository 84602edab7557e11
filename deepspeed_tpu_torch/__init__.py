"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu`` for
one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``deepspeed_tpu`` is the reference this package is held
against; this package imports nothing of it. Every Pallas kernel on a
ported path is a hand-written CUDA kernel here (``csrc/*.cu``, wrapped in
``ops/cuda/``), each beside its plain PyTorch version. Entry points run
on the card unless the caller passes ``device="cpu"``.

Ported so far: GPT-2 paged serving (``serving.build_engine``) and
single-device training (``initialize`` → ``engine.train_batch``)::

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
    ``mesh`` and ``mpu`` describe more than one rank, which the port does
    not run yet."""
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
    if mesh is not None or mpu is not None:
        raise NotImplementedError(
            f"initialize(mesh=..., mpu=...): the port trains on one rank "
            f"({ROADMAP_MULTI_RANK})")
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler, collate_fn=collate_fn,
                             config=config, loss_fn=loss_fn, device=device,
                             seed=rng)
    return engine, engine.optimizer, engine.training_dataloader, \
        engine.lr_scheduler
