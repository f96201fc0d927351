"""The service layer of the port. Only the metrics sink
(:mod:`.metrics`) is here yet; the HTTP app comes with ROADMAP A.9b."""
