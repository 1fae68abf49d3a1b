"""api.copy_link_pct: the bytes of the copies between the host and the card
over their device time, as a share of one direction of the host link
(PCIe Gen 5 x16, 64e9 B/s), in %. The API copies through pageable
memory, so this is the rate of the host's staging as the link sees it,
not the link's use (`devtrace.copy_link_pct`)."""

from benchmark import devtrace

read = devtrace.copy_link_pct
