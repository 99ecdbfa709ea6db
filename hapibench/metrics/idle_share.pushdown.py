"""idle_share.pushdown: the share of the traced window's wall time in which no operation ran on the card, in percent."""
from hapibench.readings import idle


def read(r):
    return idle(r, "pushdown")
