"""Step builders of the port. Serving only so far; the train steps come with
the training slice."""
