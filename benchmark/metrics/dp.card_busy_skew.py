"""The device list's balance of card time (traced run): the busiest card's
busy time in the traced window over the mean card's, the cell's cards
each counted (one with no device op as 0).  1.0 where the cards work
alike.  None with fewer than two cards."""


def read(run):
    busy = run.trace.busy_ns if run.trace is not None else {}
    n = max(len(busy), int(run.cell.get("chips", 1)))
    if n < 2 or not sum(busy.values()):
        return None
    return max(busy.values()) / (sum(busy.values()) / n)
