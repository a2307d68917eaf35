"""deepseek-v3-671b [moe/MLA]: 61L d_model=7168 128H vocab=129280,
MoE 1 shared + 256 routed top-8 (expert ff=2048), first 3 layers dense
(ff=18432), MLA (q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128),
MTP [arXiv:2412.19437; hf].

``optimizer`` and ``microbatch`` are the reference's training knobs
(adafactor-class optimizer state, microbatch accumulation); serving
ignores them.
"""
from ..models.config import LMConfig

FULL = LMConfig(
    name="deepseek-v3-671b", family="mla_moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab=129280, max_seq=32768,
    n_experts=256, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    first_dense_layers=3,
    q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128,
    mtp=True,
    optimizer="adafactor", microbatch=16,
)

SMOKE = LMConfig(
    name="deepseek-v3-671b-smoke", family="mla_moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=160, vocab=256, max_seq=128,
    n_experts=8, top_k=2, moe_d_ff=32, n_shared_experts=1,
    first_dense_layers=1,
    q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8, v_head=16,
    mtp=True, attn_block_q=32, attn_block_kv=32,
)
