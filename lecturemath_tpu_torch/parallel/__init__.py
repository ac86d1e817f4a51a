"""Scale-out helpers. Only the host-side lecture work queue is ported so far;
mesh sharding over several cards is later work."""
