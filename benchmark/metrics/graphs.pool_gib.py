"""GiB the pipeline's CUDA graphs hold (their private pool and static
inputs): the allocator's emptied reserve with the graphs less without."""


def read(rec: dict):
    return rec["graphs_pool_gib"]
