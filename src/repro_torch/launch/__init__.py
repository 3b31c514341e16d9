"""Launchers: the production mesh builders, the training launcher and the
meta-device dry run."""
