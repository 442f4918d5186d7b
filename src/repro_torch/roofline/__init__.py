"""The one-card roofline over the dry run's rows (:mod:`.analysis`) and
its Markdown tables (:mod:`.report`)."""
