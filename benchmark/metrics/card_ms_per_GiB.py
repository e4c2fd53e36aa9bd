"""The cards' busy time over the window (any kernel, copy or set running,
summed over the cards), ms a GiB of the round trips' input: the card time
the codec takes from the card's other users."""

from benchmark.readers import card_ms_per_gib


def read(run):
    return card_ms_per_gib(run)
