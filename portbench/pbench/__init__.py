"""The port's benchmark harness: inputs, the program's set-up, the timed
window, the trace reading and the correctness check of one cell."""
