"""The caching allocator's peak reserve over set-up and window
(`torch.cuda.max_memory_reserved`), GiB: what the card must hold."""


def read(rec: dict):
    return rec["peak_bytes"] / 2 ** 30 if rec["peak_bytes"] else None
