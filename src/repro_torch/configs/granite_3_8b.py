"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 — GQA llama-arch [hf:ibm-granite/granite-3.0; hf]."""
from ..models.config import LMConfig

FULL = LMConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab=49155, rope_theta=1e4, max_seq=32768,
    microbatch=2,
)

SMOKE = LMConfig(
    name="granite-3-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, max_seq=128,
    attn_block_q=32, attn_block_kv=32,
)
