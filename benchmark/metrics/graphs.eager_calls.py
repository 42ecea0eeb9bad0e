"""Stage calls in the window that ran their function (a first sight or a
capture) instead of replaying a CUDA graph: 0 when set-up warmed every
call key the window meets."""


def read(rec: dict):
    return rec["eager_calls"]
