"""The port's single-server COS runtime: the simulator clock, the object
store, the warm-weight cache, the compute scheduler, the server and the
client (copies of ``repro/cos``; the network fabric and the fleet are not
ported yet)."""
