"""api.copy_ms: the device ms of the copies between the host and the card
(HtoD and DtoH) per traced call: the API's upload of the pairs and download
of the maps, which a call waits for."""

from benchmark import devtrace

read = devtrace.copy_ms
