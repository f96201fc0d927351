"""The service layer of the port: the metrics sink (:mod:`.metrics`),
the aiohttp app (:mod:`.app`, ``build_app``) and its entry point
(:mod:`.main`). Importing the package loads neither aiohttp nor the app,
so the metrics sink imports where aiohttp is not installed."""
