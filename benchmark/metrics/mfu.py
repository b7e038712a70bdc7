"""The whole step's share of the card's peak: the operations of the
window's steps (`benchmark/counting.py`) over the untraced window, in %.
The operations a step are fixed by the configuration, so this is the
end-to-end step time in other units; it bounds what any kernel's gain
can claim."""


def read(o):
    if o.window_s <= 0:
        return None
    return 100.0 * o.flops / o.window_s / o.peak_flops
