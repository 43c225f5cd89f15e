"""The port's paged KV cache against the reference's, call for call.

Both caches take the same sequence of ``allocate`` / ``extend`` /
``lookup_prefix`` / ``register_prefix`` / ``set_len`` / ``release``
calls, including a prefix hit, a copy-on-write of a shared page and LRU
eviction under page pressure.  After every call the page tables,
lengths, free-page and cached/shared counts, and the call's result must
be equal; the pools (filled with the same random pages first) must stay
bit-equal through the copy-on-write.
"""
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.inference.paged_cache import PagedKVCache as RefCache

from paddle_tpu_torch.inference.paged_cache import PagedKVCache

P = 4
GEOM = dict(n_pages=12, page_size=P, n_kv_heads=2, head_dim=8, max_seqs=4,
            max_len=16, num_layers=2)
SYS = [11, 12, 13, 14, 15, 16, 17, 18]        # two full pages
A = SYS + [1, 2, 3]
B = SYS + [4, 5]


def _state(c):
    return (c.page_table.tolist(), c.seq_lens.tolist(), c.free_pages(),
            c.cached_page_count(), c.shared_page_count(),
            c.free_slot_count())


def test_cache_calls_match_reference():
    ref = RefCache(**GEOM)
    port = PagedKVCache(**GEOM, device="cpu")
    rng = np.random.default_rng(0)
    kp, vp = (rng.standard_normal(ref.k_pages.shape).astype(np.float32)
              for _ in range(2))
    ref.k_pages, ref.v_pages = jnp.asarray(kp), jnp.asarray(vp)
    port.k_pages.copy_(torch.from_numpy(kp))
    port.v_pages.copy_(torch.from_numpy(vp))

    def both(name, *args, **kw):
        want = getattr(ref, name)(*args, **kw)
        got = getattr(port, name)(*args, **kw)
        assert got == want, name
        assert _state(port) == _state(ref), name
        return got

    both("allocate", len(A) + 2)                 # slot 0: 4 pages
    both("set_len", 0, len(A))
    both("register_prefix", 0, A, upto=8)
    _, hits = both("lookup_prefix", B[:8])       # both SYS pages
    both("allocate", len(B) + 2, shared_pages=hits)
    both("set_len", 1, 6)
    both("extend", 1, 1)                         # into shared page 1:
    both("extend", 1, 4)                         #   copy-on-write
    both("release", 0)                           # SYS pages park (LRU)
    both("allocate", 16)                         # slot 0 again
    both("allocate", 8)                          # slot 2: free list dry
    both("allocate", 8)                          # slot 3 evicts SYS page 2
    assert both("lookup_prefix", A[:8]) == (P, [1])
    for slot in range(4):
        both("release", slot)
    assert (ref._ref == port._ref).all()
    np.testing.assert_array_equal(port.k_pages.numpy(),
                                  np.asarray(ref.k_pages))
    np.testing.assert_array_equal(port.v_pages.numpy(),
                                  np.asarray(ref.v_pages))


def test_copy_on_write_copies_the_page():
    port = PagedKVCache(**GEOM, device="cpu")
    port.k_pages.normal_()
    s0 = port.allocate(12)
    port.set_len(s0, 12)
    port.register_prefix(s0, A + [9], upto=8)
    n, pages = port.lookup_prefix(B[:8])
    assert n == 8
    s1 = port.allocate(12, shared_pages=pages)
    port.set_len(s1, 7)
    port.extend(s1, 1)
    new = int(port.page_table[s1, 1])
    assert new != pages[1] and port.page_ref_count(pages[1]) == 1
    assert (port.k_pages[:, :, new] == port.k_pages[:, :, pages[1]]).all()
