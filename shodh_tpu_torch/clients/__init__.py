"""Clients of the port (port of ``shodh_tpu/clients``): the Python SDK
(``client.Memory`` over HTTP, the local IPC socket or an embedded engine),
the framework adapters, the MCP stdio server and the terminal dashboard."""
