"""Launch drivers of the port: LM serving (``serve``)."""
