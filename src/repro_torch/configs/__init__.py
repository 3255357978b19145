"""Architecture configs of the port, by ``--arch`` id (see ``registry``)."""
