"""Graph containers, generators and the SSSP engine of the port."""
