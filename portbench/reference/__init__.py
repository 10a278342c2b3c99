"""The plain reference: the protocol derived again from the seeds, in plain torch."""
