"""parent_exchange_ms_per_tick: the intermediates' parent exchanges
(`server.parent_exchange`: the upstream request's aggregation, the
GetServerCapacity RPC, the install of the grants), summed over every
intermediate and the window, per iteration. In one process the parent's
handler runs inside the RPC's await; its `server.GetServerCapacity`
spans are left out, as server_capacity_ms_per_tick reads them."""

from portbench.measure import spans


def read(run):
    return spans.ms_per_iteration_less(run, "server.parent_exchange",
                                       "server.GetServerCapacity")
