"""Shared settings of the benchmark's CPU tests: tiny widths of each
configuration, in both the program and the reference."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY = {
    "mamba2-2.7b": dict(n_layers=2, d_model=64, ssm_heads=8, ssm_headdim=16,
                        ssm_state=16, vocab=300, vocab_padded=512,
                        ssm_chunk=16),
}
#: small batches whose prompts cross the tiny chunk (16)
SMALL_TRAFFIC = dict(batch=4, prompt_tokens=[20, 70], new_tokens=[1, 5])
