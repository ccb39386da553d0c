"""Configurations of the port's workloads."""
