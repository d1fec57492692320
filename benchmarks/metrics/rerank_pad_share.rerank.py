"""rerank_pad_share.rerank: the share of the token positions the rerank's
blocks run that are padding, in percent: 1 - ``rerank.tokens_real`` (the
real tokens of each block's requested pairs) / ``rerank.tokens_run``
(each block's rows x its bucket width, the rows that fill the last block
included), counted by ``Reranker`` over the traced window.
``utils.profiling.recorded()`` holds the run's one profiler recording; a
program without it reads nothing."""

from pacednegatives_tpu_torch.utils import profiling


def read(ctx):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    counts = recorded()["counts"]
    run = counts.get("rerank.tokens_run", 0)
    if not run:
        return None
    return 100.0 * (1.0 - counts.get("rerank.tokens_real", 0) / run)
