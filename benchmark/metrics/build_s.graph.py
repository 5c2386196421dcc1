"""Seconds to build the program's device graph from the generated COO:
``data.storage.coo_to_csc_device`` and ``data.graph.make_graph``, timed by
the host clock to a synchronise during set-up."""


def read(r):
    return r.build_s.get("graph")
