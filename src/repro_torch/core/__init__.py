"""Network core of the port: topology, routing, VC allocation, traffic,
the cycle-level simulator and the route-and-simulate pipeline."""
