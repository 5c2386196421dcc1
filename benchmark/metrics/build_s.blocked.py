"""Seconds to build the program's blocked layout of the CSC
(``ops.spmm_blocked.build_blocked``, host numpy, then moved to the card),
timed by the host clock to a synchronise during set-up."""


def read(r):
    return r.build_s.get("blocked")
