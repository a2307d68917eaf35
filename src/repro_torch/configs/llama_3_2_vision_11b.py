"""llama-3.2-vision-11b [vlm]: 40L text backbone d_model=4096 32H (GQA
kv=8) d_ff=14336 vocab=128256 with a gated cross-attention layer every 5
layers; vision tower STUBBED — input_specs feeds projected patch
embeddings (B, 1601, 4096) [hf:meta-llama/Llama-3.2-11B-Vision]."""
from ..models.config import LMConfig

FULL = LMConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, max_seq=32768,
    cross_every=5, img_seq=1601, rope_theta=5e5,
    microbatch=2,
)

SMOKE = LMConfig(
    name="llama-3.2-vision-11b-smoke", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, max_seq=128,
    cross_every=2, img_seq=16,
    attn_block_q=32, attn_block_kv=32,
)
