"""The share of the traced window, in percent, in which no kernel, copy
or memset ran on the card."""


def read(tr):
    if not tr.device() or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
