"""HTTP server of the port: the prompt queue, the graph executor thread and
the /distributed/* routes of the elastic tier, on the standard library
(api/httpd.py in place of aiohttp)."""
