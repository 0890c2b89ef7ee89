"""Input pipelines of the port."""
