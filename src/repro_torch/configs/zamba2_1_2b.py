"""zamba2-1.2b [hybrid]: 38 Mamba2 layers d_model=2048, ssm_state=64,
one SHARED attention+MLP block (32H MHA, d_ff=8192) invoked every 6 mamba
layers with the original embedding concatenated, vocab=32000
[arXiv:2411.15242; hf].

long_500k runs with a 4096 sliding window on the shared attention blocks
(the mamba backbone is O(1) in context).
"""
from ..models.config import LMConfig

FULL = LMConfig(
    name="zamba2-1.2b", family="zamba",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000, max_seq=32768,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=128,
    attn_every=6, window=4096,
)

SMOKE = LMConfig(
    name="zamba2-1.2b-smoke", family="zamba",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, max_seq=128,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_conv=4, ssm_chunk=32,
    attn_every=2, window=64,
    attn_block_q=32, attn_block_kv=32,
)
