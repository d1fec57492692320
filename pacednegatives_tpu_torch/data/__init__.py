"""Host-side data modules: copies of the JAX package's numpy-only
``data/{tokenizer,corpus,pipeline,spm_export}.py`` with only their import
lines rewritten. They are copied because ``pacednegatives_tpu.data``'s
``__init__`` imports JAX modules eagerly (see ROADMAP.md: fold back)."""

from pacednegatives_tpu_torch.data.corpus import TextCorpus
from pacednegatives_tpu_torch.data.pipeline import (
    PromptTemplate,
    TokenizedStore,
    pack_rows,
)
from pacednegatives_tpu_torch.data.tokenizer import (
    HashTokenizer,
    Tokenizer,
    TrainedTokenizer,
)

__all__ = [
    "HashTokenizer",
    "PromptTemplate",
    "TextCorpus",
    "TokenizedStore",
    "Tokenizer",
    "TrainedTokenizer",
    "pack_rows",
]
