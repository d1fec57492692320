"""Data modules. Host side: copies of the JAX package's numpy-only
``data/{tokenizer,corpus,pipeline,spm_export,triples}.py`` with only their
import lines rewritten, copied because ``pacednegatives_tpu.data``'s
``__init__`` imports JAX modules eagerly. Device side:
``device_corpus.DeviceCorpus``, the port of the device-resident corpus."""

from pacednegatives_tpu_torch.data.corpus import TextCorpus
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
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
from pacednegatives_tpu_torch.data.triples import TripletStore, load_triples

__all__ = [
    "DeviceCorpus",
    "HashTokenizer",
    "PromptTemplate",
    "TextCorpus",
    "TokenizedStore",
    "Tokenizer",
    "TrainedTokenizer",
    "TripletStore",
    "load_triples",
    "pack_rows",
]
