from pacednegatives_tpu_torch.models.monot5 import (
    VERBALIZER_FALSE,
    VERBALIZER_TRUE,
    relevance_log_probs,
    relevance_probs,
    score_batch,
)
from pacednegatives_tpu_torch.models.t5 import (
    T5Config,
    decode,
    encode,
    init_params,
)

__all__ = [
    "T5Config",
    "VERBALIZER_FALSE",
    "VERBALIZER_TRUE",
    "decode",
    "encode",
    "init_params",
    "relevance_log_probs",
    "relevance_probs",
    "score_batch",
]
