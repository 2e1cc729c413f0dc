"""One module a way of driving the port, named by a traffic mix's `driver`;
each exposes `run(run: harness.Run)`."""
