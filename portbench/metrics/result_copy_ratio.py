"""The bytes a result's decode copies from the device over the bytes of
the rows it returns, over the requests completed in the profiled slice:
the sums of ``service.result``'s ``host_bytes`` (what crosses to the
host: the live rows' data and validity, gathered on the card, and with a
selection the 8-byte count of them) and ``live_bytes`` (the live rows'
data and validity alone).  1.0 means nothing was copied that was then
dropped; a decode that copied whole blocks would read their capacity
over their live rows."""

from portbench import spans


def read(run):
    reqs = spans.requests(run)
    if not reqs:
        return None
    host = live = 0
    for q in reqs:
        for s in q.children:
            if s["name"] == "service.result" and "live_bytes" in s["attrs"]:
                host += s["attrs"]["host_bytes"]
                live += s["attrs"]["live_bytes"]
    return host / live if live else None
