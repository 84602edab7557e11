"""Continuous-batching serving engine with a paged KV cache, on the card.

Port of ``deepspeed_tpu/serving/__init__.py:48,77`` for both families::

    import deepspeed_tpu_torch.serving as serving
    from deepspeed_tpu_torch.models.gpt2 import gpt2_large, init_params

    cfg = gpt2_large()
    engine = serving.build_engine(
        "gpt2", cfg, init_params(cfg, seed=0),
        config={"serving": {"slots": 8, "page_size": 16,
                            "max_pages_per_slot": 64}})
    results = engine.serve([serving.Request(0, prompt_ids,
                                            max_new_tokens=64)])

LLaMA takes the packed serving weights (``models.llama_inference``)::

    from deepspeed_tpu_torch.models.llama import llama_7b
    from deepspeed_tpu_torch.models.llama_inference import \
        init_serving_params

    cfg = llama_7b()
    engine = serving.build_engine("llama", cfg,
                                  init_serving_params(cfg, seed=0),
                                  config={"serving": {...}})

Both families also serve int8: ``"quantize_bits": 8`` quantizes the
weights to int8 codes with per-layer scales when the engine is built (an
int8 tree is taken as it is) and ``"kv_cache_bits": 8`` holds the pool as
int8 codes with per-row scales.

``device=None`` means CUDA, and raises when there is no card; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

from deepspeed_tpu_torch.config.config import ServingConfig, load_param_dict
from deepspeed_tpu_torch.models import gpt2_inference, llama_inference
from deepspeed_tpu_torch.serving.adapters import (GPT2ServingAdapter,
                                                  LlamaServingAdapter)
from deepspeed_tpu_torch.serving.engine import (ContinuousBatcher,  # noqa: F401
                                                Request)
from deepspeed_tpu_torch.serving.paged_cache import (  # noqa: F401
    PagedCacheSpec, PagedKVCache, TRASH_BLOCK)
from deepspeed_tpu_torch.utils.device import resolve_device

_KNOWN = ("slots", "page_size", "max_pages_per_slot", "num_blocks",
          "kv_cache_bits")


def cache_spec_from_config(model_config, family: str, config=None,
                           **overrides) -> PagedCacheSpec:
    """Resolve a PagedCacheSpec from a model config + the ``serving``
    config block (+ keyword overrides: slots, page_size,
    max_pages_per_slot, num_blocks, kv_cache_bits)."""
    unknown = set(overrides) - set(_KNOWN) - {"quantize_bits"}
    if unknown:
        raise TypeError(f"unknown serving override(s) {sorted(unknown)}; "
                        f"valid: {list(_KNOWN) + ['quantize_bits']}")
    pd = load_param_dict(config)
    block = dict(pd.get("serving") or {})
    block.update(overrides)       # validated together with the block
    sc = ServingConfig({**pd, "serving": block})
    if family == "gpt2":
        geom = dict(n_layers=model_config.n_layer,
                    kv_heads=model_config.n_head)
    elif family == "llama":
        geom = dict(n_layers=model_config.n_layers,
                    kv_heads=model_config.kv_heads)
    else:
        raise ValueError(f"unknown serving family {family!r} "
                         "(expected 'gpt2' or 'llama')")
    return PagedCacheSpec(head_dim=model_config.head_dim,
                          dtype=model_config.dtype, **geom,
                          **{k: getattr(sc, k) for k in _KNOWN})


def build_engine(family: str, model_config, params, config=None,
                 device=None, registry=None,
                 **overrides) -> ContinuousBatcher:
    """Build a ContinuousBatcher for ``family``:

    - ``"gpt2"``: ``params`` is the port's stacked weight dict
      (``models.gpt2.init_params``, or its int8 codes from
      ``models.gpt2_inference.quantize_gpt2_inference_params``) or a JAX
      GPT-2 tree of numpy-convertible arrays (training, scan-stacked or
      unrolled, or converted inference, fp or int8), carried across by
      ``models.gpt2_inference.from_jax_params``;
    - ``"llama"``: ``params`` is the port's packed weight dict
      (``models.llama_inference.init_serving_params``) or a JAX LLaMA
      tree (packed serving or scan-stacked training), carried across by
      ``models.llama_inference.from_jax_serving_params``."""
    dev = resolve_device(device)
    pd = load_param_dict(config)
    if "serving" in pd and not ServingConfig(pd).enabled:
        raise ValueError(
            "the config's serving block sets enabled: false — drop the "
            "block (or flip the flag) to build a serving engine from it")
    spec = cache_spec_from_config(model_config, family, pd, **overrides)
    qb = overrides.get("quantize_bits",
                       ServingConfig({"serving": pd.get("serving") or {}})
                       .quantize_bits)
    if family == "gpt2":
        if gpt2_inference.is_jax_tree(params):
            params = gpt2_inference.from_jax_params(params, model_config,
                                                    dev)
        else:
            params = gpt2_inference.as_serving_params(params, model_config,
                                                      dev)
        adapter = GPT2ServingAdapter(model_config, params, spec, dev, qb)
    else:
        if llama_inference.is_jax_tree(params):
            params = llama_inference.from_jax_serving_params(
                params, model_config, dev)
        else:
            params = llama_inference.as_serving_params(params, model_config,
                                                       dev)
        adapter = LlamaServingAdapter(model_config, params, spec, dev, qb)
    return ContinuousBatcher(adapter, registry=registry)


__all__ = ["ContinuousBatcher", "Request", "PagedCacheSpec",
           "PagedKVCache", "TRASH_BLOCK", "GPT2ServingAdapter",
           "LlamaServingAdapter",
           "build_engine", "cache_spec_from_config"]
