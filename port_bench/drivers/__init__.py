"""One driver per kind of traffic (the ``kind`` of a traffic file):
``train`` and ``serve``.  A driver's ``run(job)`` sets the cell up from
the seed, measures its window, reads the traced window when asked, and
compares what the window's path produced with the reference; it returns
a :class:`port_bench.drivers.common.Outcome`."""
