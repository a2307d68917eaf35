"""minicpm3-4b [dense/MLA]: 62L d_model=2560 40H d_ff=6400 vocab=73448
— multi-head latent attention [hf:openbmb/MiniCPM3-4B; hf]."""
from ..models.config import LMConfig

FULL = LMConfig(
    name="minicpm3-4b", family="mla",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=96,
    d_ff=6400, vocab=73448, max_seq=32768,
    q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64,
    microbatch=2,
)

SMOKE = LMConfig(
    name="minicpm3-4b-smoke", family="mla",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, max_seq=128,
    q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8, v_head=16,
    attn_block_q=32, attn_block_kv=32,
)
