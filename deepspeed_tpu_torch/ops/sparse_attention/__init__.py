from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import \
    SparseSelfAttention
