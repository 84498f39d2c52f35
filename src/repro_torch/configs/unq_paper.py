"""The paper's own model configs (§4.1), over the port's ``UNQConfig``.

Deep1M: 96-d deep descriptors, 8 or 16 bytes/vector (M codebooks of
K=256), encoder/decoder with two 1024-unit hidden layers, 256-d
codewords. ``SMOKE`` is the small CPU-scale variant (same code path).
The search and training configs of ``repro.configs.unq_paper`` come with
the modules that use them.
"""
from repro_torch.core.unq import UNQConfig

DEEP_8B = UNQConfig(dim=96, num_codebooks=8, codebook_size=256,
                    code_dim=256, hidden_dim=1024, num_hidden_layers=2)
DEEP_16B = DEEP_8B.with_(num_codebooks=16)

SMOKE = UNQConfig(dim=32, num_codebooks=4, codebook_size=64, code_dim=32,
                  hidden_dim=64, num_hidden_layers=2)
