"""coloreffects preset LUTs.

A copy of gstbad_tpu/elements/video/_coloreffects_tables.py: byte-identical
curve data extracted from the reference
(gst/coloreffects/gstcoloreffects.c:117-339) by
tools/extract_luts.py.  Each table is 256 RGB triples.
"""

import base64
import numpy as np

SEPIA_TABLE = np.frombuffer(base64.b64decode(
    "AAAAAAAAAAAAAAEAAQEAAQEAAQEBAgEBAgIBAwIBAwIBAwIBBAMCBAMCBAMCBgQCBgQCBgQC"
    "BwUCBwUDCQYDCQYDCgcDCwgDDQgEDgkEDwkEEQoEEgsEEgsFEwwFFA0FFg4GGRAGGREGGhIH"
    "HBIHHRMHIBQIIBYIIRYJIxgJJhkKJhoKJxwLKRwLKh8LLB8LLSAMLiINMCINMiMPMyYPNCYP"
    "NScQOCgROSkROioTPCwTPS0TQS4UQTAVQjAVQzIWRDMYSDQYSDcZSzcaSzgaTDkbTTocUDwc"
    "UT0dUz4fVD8fVUEgVkIhWEMhWkQjXEYjXkcjXkokYEomYksnYk0nZU0oZk8pZ1ApaVEqa1Ms"
    "bVQtbVUtblYub1gvclkwc1oydV0ydl0zd14zeGA0emE1e2M3fGM4fmU4f2Y5gGk6g2k8hGo8"
    "hms9h20+iG4/iW8/i3FBjHJDjXNDj3VEkHZEkXdGk3hHlHpIlXtKl3xLmH5LmX9MmoBNnIJP"
    "nYNQnoRRoIZRoYdToohUo4lVpYtWpoxYp41ZqI9ZqpBaq5FcrJNdrJRerZVgr5dhsJhisZlj"
    "sppltJxltZ1mtp5nt6Bpt6FpuqJru6NtvKVuvKZvvqdxv6hywKpzwat1wqx2xK13xa94xq96"
    "xrF7x7J8yLR+yLV/y7aAzLeCzbeDzrqEz7uGz7yH0L6I0r+J07+L1MGM1cKN1sSP1sWQ18aR"
    "18eT2ciU28mV3MmX3MuX3c2Z3c6Z38+c4NCd4dCd4dOg4tSh49Si49aj5del5dil5tmo5tuq"
    "59yr6d2s6d2t6d+v6uCw6+Gw7OKy7eO07eS17eW27ua27ue67+i78Om88Om+8eq/8evA8uvB"
    "8uzC8u3E8u7F9O/F9O/I9PDJ9fHL9fHM9vLN9vLO9vPO9/TQ9/TQ9/XU9/XU+PbW+PbX+fbY"
    "+ffZ+ffb+fjb+vje+vje+vng+/nh+/ri+/rj/Prk/Pvk/Pvn/Pzo/fzp/fzp/fzq/f3q/v3r"
    "/v7t/v7u/v7v///v"
), dtype=np.uint8).reshape(256, 3)

HEAT_TABLE = np.frombuffer(base64.b64decode(
    "AAAAAAAAAAEAAAEAAAEBAAIBAAIBAQIBAQICAQICAQMCAQMDAQMDAQQDAQQEAQUEAQUFAgUG"
    "AgYGAgYHAgYHAgcHAgcJAggJAggKAwkLAwkLAwkMAwoNAwoPAwsPAwwQAwwSBA0TBA4UBA4W"
    "BA4XBA8ZBBAcBBEcBREgBRIgBRIkBRMkBRUmBhUoBhYtBhYtBhcwBhkyBxk1Bxo7Bxw7Bxw/"
    "CB1DCB5HCB9MCCBWCSFWCSJbCSRhCSZsCiZsCidyCih+Cyp+CyyEDCyLDC6RDC+XDDGeDTKk"
    "DTSqDTWwDje3Dji9DzrCDzvIDz3TED/TEUDYEUTdEUTiEkXmEknrE0nuE0vyFE31FE74FVD6"
    "FlL8FlT+Flb/F1j/F1r/GFz+GWD+GWD9GmL7GmT5G2b2HGrzHGrwHWzsHm7oHnLkH3LfIHTb"
    "IHfWIXnRInzMI37HJIHBJIS3JYe3JoqxJ4ysKI+nKJKhKZacKpmXK5ySLJ+OLaKJLqWFL6mB"
    "MKx9Ma96MrJ3M7Z0NLlwNbxtNr9qN8JmOMVjOchgOsxcO89ZPNFWPtRTP9dQQNpMQd1JQt9G"
    "Q+JDReRARuc9R+k7Ses4Se04Te8zUPEwU/MuVvUrWfYpXPgnYPklZPojZ/sibPwgcPwfdPwd"
    "dP0cff4bgv4agv0Zi/0YkP0Xlf0XmvsWn/oVpPkUqfgTrvcTsvcSt/QRvPIQwPEQxe8Pye0O"
    "yesO0ukN1uYN2uYM3uQM4d8L4d0L6NoK69gJ7tgJ8NII8tAI9NAI9MoH9scH9sQH98IG978G"
    "+LwF97kF97kF97ME9bAE9K0E86sD8qgD8aUD8KID76AD750C7ZoC7ZcC7JUC65EB644B644B"
    "64sB64QB64EB7H0B7HkA7HYA7XIA7W4A7WoA7mYA7mIA718A71sA71cA71MA8E8A8E8A8UsA"
    "8UMA8kAA8zwA8zgA9DgA9DEA9S4A9isA9icA9ycA+CEA+B4A+BsA+RgA+RYA+xYA+xMA/A0A"
    "/AsA/QgA/QUA/gMA"
), dtype=np.uint8).reshape(256, 3)

XRAY_TABLE = np.frombuffer(base64.b64decode(
    "/////////v7+/f3+/P39+/z9+vz8+fz8+Pv79vv69vr69fr58/n58/n48vj48Pj38Pf27/f1"
    "7vb17fb06/Xz6/Xz6vTy6fPy5/Px5vLx5fLx5PLw4/Hv4/Hu4vDu4fDu4O/t3u7s3u7s3e3r"
    "3O3r2+3q2ezp2evp2Ovo1+vo1ern1enn1Ojm0+jl0ufk0efk0Ofkz+bjzubizeXhzOThy+Tg"
    "yuTgyePfyOLfx+LdxuHdxeHdw+Dcw9/bwt/bwd/awN7Zvt3ZvtzYvNzYvNzXu9vXutvWudrV"
    "uNrVt9nUttjTtdjTtNfSs9fRstbQsdXQr9XPr9TPrtTOrNPNrNLNq9LMqtHLqdHLqNDKps/J"
    "pc/Jpc7IpM7Ho83HoszGoczFoMrFn8rEnsrDncnDnMnCm8fBmsfAmcfAmMa/l8W+lsW+lcS9"
    "lMO8k8O7ksK7kcG6kMG5j8C4jr+4jb+3jL62i721ir21iby0iLuzh7uyhrqyhbmxhLiwg7iv"
    "grevgbaugLatf7WsfrSrfbOrfLOqe7KperGoebCneLCnd6+mdq6lda2kdK2jc6yjcquicaqh"
    "cKqgb6mfbqiebaedbKadbKadaqWbaaSaaKOZZ6KYZqKXZaGWZKCWY5+VYp6UYZ2TYJySX5yR"
    "X5uQXZqPXJmOXJiNWpeMWZaMWJaLV5WKVpSJVZOIVJKHU5GGUpGFUY+EUI6DT42CTo2BTYyA"
    "TYt/S4p+Sol9SYl8SIh8R4Z6R4V6RYR4RIN2Q4N2QoF0QYBzQIBxQH5wPn1vPnxvPHtsPHlr"
    "O3hpOXdoOHdnOHRlNnNkNXFkNHBhM25fMm1dMWtcMGpcMGhZLmZXLWRVLGNUK2FSKl9QKV9P"
    "KF1NJ1lLJ1hJJVZJJFRGJFJEIk9CIU1AIEs/H0k9H0c9HUU5HEM5HEE1Gz41GTwyGTwwFzou"
    "FzUsFjMqFDEqEy4mEi4mEioiEScgDyUeDiIcDSIaDB4aCxsWCxkUCRYSCRQQBxQOBhEOBQwM"
    "BAoIAwcGAwUEAQIC"
), dtype=np.uint8).reshape(256, 3)

XPRO_TABLE = np.frombuffer(base64.b64decode(
    "AAAfAAAfAAEgAAIhAAIiAAMiAQQlAQQlAQUlAQUnAQcnAQcoAQcoAQgqAQkrAQksAQosAQsv"
    "AQwvAQwxAg0xAg0xAg40Ag80Aw81AxI3AxI3AxM4AxQ5AxU7AxY7Axc8Axc9BBk9BBs/BBxA"
    "BRxCBR1DBR5EBSBEBSBHBSFHBiJIBiRIByZKByZLBypNBypNCCtOCC1QCS1QCS9SCTNSCTNU"
    "CjRVCjVVCzdXDDhZDDlZDDxZDj1bDkBeDkBeD0NeD0RgEEZgEEpiEkpiEktjE01lFE5mFVFn"
    "FlJnF1RpF1dqGFhsGVlsG1xtHF5wHWBwIGJwIGZxIWZyJGd0JGx0JWx1J212KHB4KnF5LXR5"
    "L3V6L3h8MHl9M3x9NH1+NX+BOIOBOYOBO4SCPYeDP4iEQIyEQ4yGRI6HR4+ISJOJS5OJTZWK"
    "UJaMUZmNVJqNVZyOWJ2PWaCQXKGQXqORYKSTYqaUZaiUZqqVaauWbK2Xba6ZcLGZcbKadLSb"
    "drWceLeceridfLmefryggb2ggr+hhMCih8KjiMOjisWkjMaljsemkMmokcuolM2pls6ql8+r"
    "mtGrnNKsndOtoNWuotauotiupdmxqNmyqdqyq9yzrd20rt61seC2s+G2tOK3tuO4uOS5ueS5"
    "uea7vue8v+i9v+m9wuq+xOu/xuvAx+3Aye7BzO7Cze/Dz/DE0PDE0vHF0/LG1fLH1/PH2PPI"
    "2PTJ2/TL3PXL3vXM4PXM4vbO4vbO5vfP5/fQ6ffQ6/jS7PjS7vjT7vjU8PnV8PnV8/nW8/nX"
    "8/rY9frY9vrZ9vrZ+Pra+fva+fvb+vvc+/vd+/ve/Pve/Pzf/Pzg/fzh/fzh/vzi/vzj/vzk"
    "/vzk//zl//zm//3m//3m//3n//3o//3p//3q//3q//3q//3r//3r//7s//7s//7u//7u//7u"
    "//7v//7w//7w//7w//7w//7y//7y//7z//7z//7z//7z//70//70//71///1///2///2///2"
    "///3///3///3///4"
), dtype=np.uint8).reshape(256, 3)

YELLOWBLUE_TABLE = np.frombuffer(base64.b64decode(
    "AAD/AQH+AgL9AwP8BAT7BQX6Bgb5Bwf4CAj3CQn3Cgr1Cwv0DAzzDQzyDg7xDw/wEBDvEBHu"
    "EhLtExPsFBTsFBXqFhbpFxfoFxjnGRnmGhrlGxrkHBzjHBziHh7hHx7gICDfISHeISHdIyPc"
    "JCPcJSXaJiXZJybYKCjXKCnWKinVKyvULCzTLS3SLi7RLy/QLzDPMTHPMjLNMjLMNDTMNDXL"
    "NTXKNzbJODjHOTnGOTrFOzvFPDzEPT3CPj7BPj7AQEDAQEG+QUK9QkO8Q0S7REW6RUW6Rka4"
    "SEi4SEm2SUq1S0u0S0yzTU2yTk6yTk6xT0+vUVCuUlGuUlKsVFSrVVWrVlWpVleoWFinWFmm"
    "WVqlW1ulW1ujXV2jXl6iXl+gX2CfYGGeYWGdYmKdZGObZGWbZmaaZ2aZaGeYaGmXammWa2qV"
    "bGuTbG2Tbm2Sbm6Rb3CPcXGOcnKNc3OMc3SLdXWLdXWJd3aId3eHeHiHeXqFenuFe3uEfHyD"
    "fX2Cf36Bf4B/gIF/goJ+g4J8hIN8hIR7hYZ6h4Z4h4d3iYh3iYl2iop1i4xzjIxyjY1yjo9x"
    "j49wkZBvkZJuk5JslJNrlJRrlZVqlpZpl5domJlmmZlmm5plm5tjnJxjnZ1inp5hn59goaBf"
    "oqFeoqJdo6RcpKRbpaVZpqZZqKdYqKhXqalWqqpUq6tUrK1Trq1Sr65Rr7BQsLFPsbFOsrJN"
    "s7NMtLVLtbVKtrZJt7hIuLhHublGurpFu7tDvLxCvb1Cvr5Bv79AwMA/wcE+wsI9w8M8xMQ7"
    "xcU6xsY5x8c4yMg3yck2yso1y8s0zMwzzc0yzs4xz88w0NAv0dEu0tIt09Ms09Qr1dUq1tYp"
    "19co2Ngn2dkm2tkl29ok3Nwj3N0i3t4h398g4OAf4eEe4uId4+Mc5OQb5eUa5eYZ5+cY6OgX"
    "6ekW6uoV6+sU7OwT7O0S7u4R7+8Q8PAP8fEO8vIN8/IM9PQL9fUK9fYJ9/cJ+PgH+fkG+vkF"
    "+/sE/PwE/f0D/f4B"
), dtype=np.uint8).reshape(256, 3)

TABLES = {
    "sepia": SEPIA_TABLE,
    "heat": HEAT_TABLE,
    "xray": XRAY_TABLE,
    "xpro": XPRO_TABLE,
    "yellowblue": YELLOWBLUE_TABLE,
}
