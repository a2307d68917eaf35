"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
— llama-arch GQA [arXiv:2403.04652; hf]."""
from ..models.config import LMConfig

FULL = LMConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000, rope_theta=1e4, max_seq=32768,
    microbatch=2,
)

SMOKE = LMConfig(
    name="yi-9b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=256, max_seq=128,
    attn_block_q=32, attn_block_kv=32,
)
