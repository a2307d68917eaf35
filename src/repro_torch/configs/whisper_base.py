"""whisper-base [audio enc-dec]: 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865; conv/mel frontend STUBBED — input_specs feeds precomputed
frame embeddings (B, 1500, 512) [arXiv:2212.04356].

The assigned 32k decode cache exceeds Whisper's real 448-token decoder
context; the backbone honors the assigned shape (pos table sized from it).
"""
from ..models.config import LMConfig

FULL = LMConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865, max_seq=32768,
    enc_layers=6, enc_seq=1500,
)

SMOKE = LMConfig(
    name="whisper-base-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, max_seq=128,
    enc_layers=2, enc_seq=64,
    attn_block_q=32, attn_block_kv=32,
)
