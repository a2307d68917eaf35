"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4, head_dim 128,
qk-norm) vocab=151936, MoE 128 experts top-8 (expert ff=768)
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from ..models.config import LMConfig

FULL = LMConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936, max_seq=32768,
    n_experts=128, top_k=8, moe_d_ff=768,
    qk_norm=True, rope_theta=1e6,
    microbatch=2,
)

SMOKE = LMConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab=256, max_seq=128,
    n_experts=8, top_k=2, moe_d_ff=64, qk_norm=True,
    attn_block_q=32, attn_block_kv=32,
)
