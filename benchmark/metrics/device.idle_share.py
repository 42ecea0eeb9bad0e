"""Share of the traced clips' wall time in which no record ran on the
device (1 - the union of the records' intervals / the clips' wall), %."""


def read(rec: dict):
    if "busy_s" not in rec or not rec["trace_window_s"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["trace_window_s"])
