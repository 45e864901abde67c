"""idle_pct.offline: the device's idle share of the traced window (the part
of it in which no kernel, copy or memset ran: `TraceView.idle_pct`), in
a cell that reports the end-to-end metric this one moves."""

UNIT = "%"


def read(view):
    return view.idle_pct()
