"""The bytes a result's decode copies from the device over the bytes of
the rows it returns, over the requests completed in the profiled slice:
the sums of ``service.result``'s ``host_bytes`` (the selection mask and
every column at the block's whole capacity) and ``live_bytes`` (rows
returned times each column's bytes a row).  1.0 means nothing was copied
that was then dropped."""

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
