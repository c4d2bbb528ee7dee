"""Node-axis context and post-recovery state surgery of the port."""
