"""Runnable examples of the port (`python -m grtrace_torch.examples.<name>`)."""
