"""The benchmark's harness: inputs, the driven calls, spans, the trace and
the result line (see ``runner.run_cell``)."""
