"""Configurations of the port: the paper's evaluated cluster (Table II)."""
