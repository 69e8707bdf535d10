"""The frozen FLOP and byte counts against hand counts at small shapes."""
from perfbench import yardstick as Y

SSM = dict(family="ssm", n_layers=2, d_model=8, vocab=10, ssm_state=4,
           ssm_heads=4, ssm_headdim=4, ssm_expand=2, conv_kernel=3)
HYB = dict(family="hybrid", n_layers=3, d_model=8, n_heads=2, n_kv_heads=1,
           head_dim=4, d_ff=16, vocab=10, window=2, global_attn_layers=[0],
           ssm_state=4, ssm_heads=2, ssm_headdim=4, ssm_expand=1,
           conv_kernel=3)


def test_decay_scan_bytes_and_flops():
    # a, x read and the states written: 3 x 2*5*7 floats; the final state
    # 2*7, s0 2*7 when given
    assert Y.decay_scan_bytes(2, 5, 7, False) == 4 * (210 + 14)
    assert Y.decay_scan_bytes(2, 5, 7, True) == 4 * (210 + 28)
    assert Y.decay_scan_flops(2, 5, 7) == 140


def test_ssm_request_flops_by_hand():
    # d_inner 16: in 8*(2*16 + 2*4 + 4) = 352, conv 3*(16 + 8) = 72,
    # out 16*8 = 128 -> 552 weights a layer; prompt 5 + 3 new -> 7 tokens
    tokens, layers = 7, 2
    weights = 2 * 552 * layers * tokens
    unembed = 2 * 8 * 10 * 3
    recurrence = 4 * 4 * 4 * 4 * tokens * layers
    assert Y.request_flops(SSM, 5, 3) == weights + unembed + recurrence


def test_hybrid_request_flops_by_hand():
    # attn 8*(2+2)*4 + 2*4*8 = 192, mlp 3*8*16 = 384, ssm (d_inner 8):
    # 8*(16+8+2) + 3*(8+8) + 8*8 = 320 -> 896 a layer; 4 tokens
    tokens = 4
    weights = 2 * 896 * 3 * tokens
    unembed = 2 * 8 * 10 * 2
    recurrence = 4 * 2 * 4 * 4 * tokens * 3
    # keys seen: global 1+2+3+4 = 10; window 2: 1+2+2+2 = 7
    attention = 4 * 2 * 4 * (10 + 2 * 7)
    assert Y.request_flops(HYB, 3, 2) == (weights + unembed + recurrence
                                          + attention)


def test_peaks_are_the_data_sheet():
    assert (Y.PEAK_BF16_FLOPS, Y.HBM_BYTES_PER_S) == (989e12, 3.35e12)
