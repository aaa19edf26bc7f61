// Bit-indexed LRU response cache for the native engine.
//
// Reference: horovod/common/response_cache.{h,cc} — an LRU of Responses keyed
// by tensor name + parameters (op/dtype/shape/root), bit-indexed so per-cycle
// coordination is a bitvector AND across ranks (response_cache.cc:303)
// instead of the full negotiation. A hit whose parameters changed
// invalidates the entry (propagated with an OR pass).
//
// Coherence contract (same as the Python twin,
// horovod_tpu_torch/common/response_cache.py): cache state must evolve
// identically on every rank so bit positions stay coherent. lookup()
// therefore does NOT touch LRU order (local queue order may differ per rank); touch() and put() are called only
// at points ordered identically across ranks (bypass execution walks agreed
// bits in ascending order; puts happen in ResponseList order).

#ifndef HVD_TPU_RESPONSE_CACHE_H_
#define HVD_TPU_RESPONSE_CACHE_H_

#include <cstdint>
#include <list>
#include <map>
#include <string>
#include <vector>

#include "message.h"

namespace hvd {

class ResponseCache {
 public:
  explicit ResponseCache(int capacity) : capacity_(capacity) {
    for (int i = 0; i < capacity; i++) free_bits_.push_back(i);
  }

  // Bit position on a parameter-exact hit; -1 on miss.
  int lookup(const Request& req) const {
    auto it = entries_.find(req.tensor_name);
    if (it == entries_.end()) return -1;
    if (!it->second.params.same_params(req)) return -1;
    return it->second.bit;
  }

  // Bit of a same-name entry whose params no longer match; -1 if none.
  int stale_bit(const Request& req) const {
    auto it = entries_.find(req.tensor_name);
    if (it == entries_.end()) return -1;
    return it->second.params.same_params(req) ? -1 : it->second.bit;
  }

  // LRU-touch (bypass execution; deterministic order across ranks).
  void touch(int bit) {
    auto it = by_bit_.find(bit);
    if (it == by_bit_.end()) return;
    auto& e = entries_[it->second];
    lru_.erase(e.lru_pos);
    lru_.push_back(it->second);
    e.lru_pos = std::prev(lru_.end());
  }

  bool get(int bit, std::string* name, Response* response) const {
    auto it = by_bit_.find(bit);
    if (it == by_bit_.end()) return false;
    *name = it->second;
    *response = entries_.at(it->second).response;
    return true;
  }

  void put(const Request& req, const Response& response) {
    if (capacity_ <= 0) return;
    auto it = entries_.find(req.tensor_name);
    if (it != entries_.end()) {
      it->second.params = req;
      it->second.response = response;
      lru_.erase(it->second.lru_pos);
      lru_.push_back(req.tensor_name);
      it->second.lru_pos = std::prev(lru_.end());
      return;
    }
    if (free_bits_.empty()) {
      // Evict LRU (reference response_cache.cc put path).
      const std::string& old_name = lru_.front();
      int old_bit = entries_[old_name].bit;
      by_bit_.erase(old_bit);
      entries_.erase(old_name);
      lru_.pop_front();
      free_bits_.push_back(old_bit);
    }
    int bit = free_bits_.front();
    free_bits_.erase(free_bits_.begin());
    Entry e;
    e.bit = bit;
    e.params = req;
    e.response = response;
    lru_.push_back(req.tensor_name);
    e.lru_pos = std::prev(lru_.end());
    entries_[req.tensor_name] = e;
    by_bit_[bit] = req.tensor_name;
  }

  void evict_bit(int bit) {
    auto it = by_bit_.find(bit);
    if (it == by_bit_.end()) return;
    auto& e = entries_[it->second];
    lru_.erase(e.lru_pos);
    entries_.erase(it->second);
    by_bit_.erase(it);
    free_bits_.push_back(bit);
  }

  size_t size() const { return entries_.size(); }
  int capacity() const { return capacity_; }

 private:
  struct Entry {
    int bit = -1;
    Request params;
    Response response;
    std::list<std::string>::iterator lru_pos;
  };

  int capacity_;
  std::map<std::string, Entry> entries_;
  std::map<int, std::string> by_bit_;
  std::vector<int> free_bits_;
  std::list<std::string> lru_;  // front = least recently used
};

// Fixed-width bitmask helpers (the wire carries capacity/64 words; the
// Python controller uses arbitrary-precision ints for the same masks).
class BitMask {
 public:
  explicit BitMask(int nbits)
      : words_((size_t)((nbits + 63) / 64), 0) {}
  explicit BitMask(std::vector<uint64_t> words) : words_(std::move(words)) {}

  void set(int bit) { words_[bit / 64] |= (uint64_t)1 << (bit % 64); }
  bool test(int bit) const {
    size_t w = (size_t)(bit / 64);
    if (w >= words_.size()) return false;
    return (words_[w] >> (bit % 64)) & 1;
  }
  void and_with(const BitMask& o) {
    for (size_t i = 0; i < words_.size(); i++)
      words_[i] &= i < o.words_.size() ? o.words_[i] : 0;
  }
  void or_with(const BitMask& o) {
    for (size_t i = 0; i < words_.size(); i++)
      if (i < o.words_.size()) words_[i] |= o.words_[i];
  }
  void and_not(const BitMask& o) {
    for (size_t i = 0; i < words_.size(); i++)
      if (i < o.words_.size()) words_[i] &= ~o.words_[i];
  }
  std::vector<int> bits() const {
    std::vector<int> out;
    for (size_t w = 0; w < words_.size(); w++) {
      uint64_t v = words_[w];
      while (v) {
        int b = __builtin_ctzll(v);
        out.push_back((int)(w * 64 + (size_t)b));
        v &= v - 1;
      }
    }
    return out;
  }
  const std::vector<uint64_t>& words() const { return words_; }

 private:
  std::vector<uint64_t> words_;
};

}  // namespace hvd

#endif  // HVD_TPU_RESPONSE_CACHE_H_
