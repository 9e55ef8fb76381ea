"""Cluster-scale simulation layer: synthetic workload generation
(`workload`), sharded fleet execution behind the placement seam (`fleet`)
and fleet-level analytics over `SimReport` (`analytics`)."""
