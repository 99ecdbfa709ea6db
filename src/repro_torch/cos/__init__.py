"""The port's HAPI runtime: the simulator clock, the object store, the
warm-weight cache, the compute scheduler, the server, the client, the
shared network fabric and the multi-replica fleet (copies of
``repro/cos``)."""
