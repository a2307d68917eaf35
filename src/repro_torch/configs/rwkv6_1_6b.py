"""rwkv6-1.6b [ssm/linear-attn]: 24L d_model=2048 (attn-free, 32 heads of
64), d_ff=7168, vocab=65536 — Finch data-dependent decay
[arXiv:2404.05892]."""
from ..models.config import LMConfig

FULL = LMConfig(
    name="rwkv6-1.6b", family="rwkv",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab=65536, max_seq=32768,
    rwkv_lora=64, rwkv_chunk=128,
)

SMOKE = LMConfig(
    name="rwkv6-1.6b-smoke", family="rwkv",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, max_seq=128,
    rwkv_lora=16, rwkv_chunk=32,
)
