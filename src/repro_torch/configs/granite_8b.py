"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch, code [arXiv:2405.04324; hf]."""
from ..models.config import LMConfig

FULL = LMConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=49152, rope_theta=1e4, max_seq=32768,
    microbatch=2,
)

SMOKE = LMConfig(
    name="granite-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab=256, max_seq=128,
    attn_block_q=32, attn_block_kv=32,
)
